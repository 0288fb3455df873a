"""Command-line tools beside the port's command line (main.py), each run
as `python -m denseslam_tpu_torch.tools.X`: a dataset downscaler
(scale_sequence), the flagship drive's evaluation (long_drive_eval), the
sharded map's dry run and scaling (dryrun_multichip, bench_scaling), and
the experiment tools of the JAX package's scripts/: the demo (run_demo),
the synthetic fixture (make_synthetic_dataset), dataset preparation
(prepare_dataset), the regularisation sweeps (decay_exp, lowfreq_exp,
odo_exp, tracking_exp), the raycast-depth scorer (eval_raycast_depth),
the memory figure (memory_draw) and the contact sheet (contact_sheet);
and where the card and the CPU part from equal inputs (device_trace)."""
