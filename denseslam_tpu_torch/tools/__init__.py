"""Command-line tools beside the port's command line (main.py): a dataset
downscaler (scale_sequence) and the flagship drive's evaluation
(long_drive_eval), each run as `python -m denseslam_tpu_torch.tools.X`."""
