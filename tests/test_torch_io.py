"""The port's IO layer against the JAX package's and against cv2: PFM,
the PNG codec and image operations of io/png.py (cv2 is their oracle),
the native codecs and prefetcher (both libraries built from
native/dsio.cpp), the dataset reader `Input` on KITTI- and TUM-layout
fixtures, the trajectory writers, the camera helpers and the timer stack.
No JAX program runs here.

Tolerances: everything is exact (equal arrays of equal dtype, equal
bytes), except the quaternion round trip (1e-6). The three defects that
the port's reader inherits from the JAX one are matched and named in the
tests ending in `_inherited`.
"""

import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from denseslam_tpu.io import datasets as jds
from denseslam_tpu.io import pfm as jpfm
from denseslam_tpu.io import trajectory as jtraj
from denseslam_tpu.utils import camera as jcam
from denseslam_tpu.utils import timing as jtiming
from denseslam_tpu_torch.io import datasets as pds
from denseslam_tpu_torch.io import pfm as ppfm
from denseslam_tpu_torch.io import png
from denseslam_tpu_torch.io import trajectory as ptraj
from denseslam_tpu_torch.utils import camera as pcam
from denseslam_tpu_torch.utils import timing as ptiming

RNG = np.random.default_rng(20)


def _image(shape, dtype):
    """Smooth ramps plus noise: cv2's adaptive filter choice varies."""
    hi = np.iinfo(dtype).max
    h, w = shape[:2]
    ramp = (np.arange(w)[None] * 7 + np.arange(h)[:, None] * 3) % (hi + 1)
    ramp = ramp.reshape((h, w) + (1,) * (len(shape) - 2))
    noise = RNG.integers(0, max(hi // 16, 2), shape)
    return ((ramp + noise) % (hi + 1)).astype(dtype)


# -- PFM ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(13, 17), (9, 11, 3)])
def test_pfm_reads_the_jax_files_and_back(tmp_path, shape):
    img = RNG.standard_normal(shape).astype(np.float32)
    a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    jpfm.write_pfm(a, img, scale=2.0)
    ppfm.write_pfm(b, img, scale=2.0)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    for p in (a, b):
        np.testing.assert_array_equal(ppfm.read_pfm(p), jpfm.read_pfm(p))


def test_pfm_big_endian_and_bottom_up_rows(tmp_path):
    img = RNG.standard_normal((5, 7)).astype(np.float32)
    p = str(tmp_path / "be.pfm")
    with open(p, "wb") as f:
        f.write(b"Pf\n# a comment\n7 5\n1.0\n")
        f.write(np.flipud(img).astype(">f4").tobytes())
    np.testing.assert_array_equal(ppfm.read_pfm(p), img)
    np.testing.assert_array_equal(ppfm.read_pfm(p), jpfm.read_pfm(p))


# -- PNG -----------------------------------------------------------------------

PNG_KINDS = {"gray8": ((37, 53), np.uint8), "gray16": ((37, 53), np.uint16),
             "bgr8": ((31, 29, 3), np.uint8),
             "bgra8": ((23, 19, 4), np.uint8)}


@pytest.mark.parametrize("kind", sorted(PNG_KINDS))
def test_png_reads_cv2_files_as_cv2_does(tmp_path, kind):
    cv2 = pytest.importorskip("cv2")
    shape, dtype = PNG_KINDS[kind]
    for i in range(3):
        img = _image(shape, dtype)
        p = str(tmp_path / f"{i}.png")
        assert cv2.imwrite(p, img)
        ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        got = png.read_png(p)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(path, img, ftype):
    """A PNG whose every row uses filter `ftype` (gray or RGB order)."""
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 0 if img.ndim == 2 else 2
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = (1 if ctype == 0 else 3) * depth // 8
    prior = np.zeros_like(rows)
    prior[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    upleft = np.zeros_like(rows)
    upleft[:, bpp:] = prior[:, :-bpp]
    pred = {0: 0, 1: left, 2: prior, 3: (left + prior) >> 1,
            4: _paeth(left, prior, upleft)}[ftype]
    filt = ((rows - pred) % 256).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8), filt], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_every_row_filter(tmp_path, ftype):
    """Each of the five row filters (None, Sub, Up, Average, Paeth) on
    every row, at 8 and 16 bits, gray and RGB; cv2 reads the same."""
    cv2 = pytest.importorskip("cv2")
    for shape, dtype in (((19, 23), np.uint8), ((19, 23), np.uint16),
                         ((17, 13, 3), np.uint8)):
        img = _image(shape, dtype)
        p = str(tmp_path / f"f{ftype}.png")
        _encode(p, img, ftype)
        ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        got = png.read_png(p)
        assert np.array_equal(got, ref)
        want = img if img.ndim == 2 else img[..., ::-1]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(PNG_KINDS))
def test_cv2_reads_the_port_png(tmp_path, kind):
    cv2 = pytest.importorskip("cv2")
    shape, dtype = PNG_KINDS[kind]
    img = _image(shape, dtype)
    p = str(tmp_path / "x.png")
    png.write_png(p, img)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype and np.array_equal(back, img)
    assert np.array_equal(png.read_png(p), img)


def test_bgr_to_gray_equals_cv2_on_every_uint8_colour():
    cv2 = pytest.importorskip("cv2")
    c = np.arange(256, dtype=np.uint8)
    every = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(
        4096, 4096, 3)
    assert np.array_equal(png.bgr_to_gray(every),
                          cv2.cvtColor(every, cv2.COLOR_BGR2GRAY))
    for img in (_image((29, 31, 4), np.uint8), _image((29, 31, 3), np.uint16)):
        ref = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        got = png.bgr_to_gray(img)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("scale", [0.5, 0.7, 0.25])
@pytest.mark.parametrize("shape", [(120, 160), (370, 1226), (61, 83, 3),
                                   (40, 48, 4)])
def test_resize_equals_cv2(shape, scale):
    """INTER_AREA (the whole-number factors' box means and the general
    table of partial weights) and INTER_NEAREST, bit for bit on random
    float32 images, also at a non-integer scale."""
    cv2 = pytest.importorskip("cv2")
    img = RNG.uniform(0, 255, shape).astype(np.float32)
    size = (int(shape[1] * scale), int(shape[0] * scale))
    assert np.array_equal(png.resize_area(img, size),
                          cv2.resize(img, size, interpolation=cv2.INTER_AREA))
    assert np.array_equal(
        png.resize_nearest(img, size),
        cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("scale", [0.5, 0.25, 1 / 3, 0.7])
@pytest.mark.parametrize("shape", [(120, 160), (121, 161, 3), (480, 640, 3)])
def test_resize_area_uint8_equals_cv2(shape, scale):
    """INTER_AREA of uint8 images (tools/scale_sequence.py shrinks the
    8-bit image folders so): at 2 x 2 cv2's (s + 2) >> 2, at other
    whole-number factors and at fractional ones its float32 result
    rounded half to even, bit for bit."""
    cv2 = pytest.importorskip("cv2")
    img = RNG.integers(0, 256, shape).astype(np.uint8)
    size = (max(1, round(shape[1] * scale)), max(1, round(shape[0] * scale)))
    got = png.resize_area(img, size)
    assert got.dtype == np.uint8
    assert np.array_equal(got, cv2.resize(img, size,
                                          interpolation=cv2.INTER_AREA))


# -- native codecs -------------------------------------------------------------

@pytest.fixture(scope="module")
def natives():
    from denseslam_tpu.io import native as jnative
    from denseslam_tpu_torch.io import native as pnative
    jnative.ensure_built()
    path = pnative.ensure_built()
    assert os.path.dirname(path).endswith(os.path.join("build", "native"))
    return jnative, pnative


def test_native_codecs_match_the_jax_binding(tmp_path, natives):
    jn, pn = natives
    f = RNG.standard_normal((21, 34)).astype(np.float32)
    pn.write_pfm(str(tmp_path / "p.pfm"), f)
    jn.write_pfm(str(tmp_path / "j.pfm"), f)
    for p in ("p.pfm", "j.pfm"):
        np.testing.assert_array_equal(pn.read_pfm(str(tmp_path / p)),
                                      jn.read_pfm(str(tmp_path / p)))
    np.testing.assert_array_equal(pn.read_pfm(str(tmp_path / "p.pfm")), f)
    for img, bits in ((_image((20, 30), np.uint16), 16),
                      (_image((20, 30, 3), np.uint8).astype(np.uint16), 8)):
        pn.write_png(str(tmp_path / "p.png"), img, bitdepth=bits)
        jn.write_png(str(tmp_path / "j.png"), img, bitdepth=bits)
        assert ((tmp_path / "p.png").read_bytes()
                == (tmp_path / "j.png").read_bytes())
        for p in ("p.png", "j.png"):
            got = pn.read_png(str(tmp_path / p))
            assert np.array_equal(got, jn.read_png(str(tmp_path / p)))
            assert np.array_equal(got, img)


def test_native_prefetch_loader_matches_the_jax_loader(tmp_path, natives):
    jn, pn = natives
    paths = []
    for i in range(5):
        p = str(tmp_path / f"{i}.png")
        pn.write_png(p, _image((16, 24), np.uint8).astype(np.uint16),
                     bitdepth=8)
        paths.append(p)
    with pn.PrefetchLoader(paths, ahead=2, threads=2) as a, \
            jn.PrefetchLoader(paths, ahead=2, threads=2) as b:
        got, ref = list(a), list(b)
    assert len(got) == len(ref) == 5
    for x, y in zip(got, ref):
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


# -- Input ---------------------------------------------------------------------

RAW_W, RAW_H = 84, 66          # files; the rigs below crop them
CROP = jcam.Intrinsics(60.0, 60.0, 39.5, 29.5, 80, 60)
N_FRAMES = 5


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """KITTI odometry layout written by cv2: gray and colour pairs, PFM
    disparities for frames 0-2 and 16-bit PNG ones for 3-4, calib.txt."""
    cv2 = pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("kitti"))
    ds = jds.kitti_odometry_config()
    for sub in ("image_0", "image_1", "image_2", "image_3", ds.depth_folder):
        os.makedirs(os.path.join(root, sub))
    for i in range(N_FRAMES):
        name = f"{i:06d}"
        for sub in ("image_0", "image_1"):
            cv2.imwrite(os.path.join(root, sub, name + ".png"),
                        _image((RAW_H, RAW_W), np.uint8))
        for sub in ("image_2", "image_3"):
            cv2.imwrite(os.path.join(root, sub, name + ".png"),
                        _image((RAW_H, RAW_W, 3), np.uint8))
        disp = RNG.uniform(0, 40, (RAW_H, RAW_W)).astype(np.float32)
        disp[RNG.random(disp.shape) < 0.1] = 0.0
        if i < 3:
            jpfm.write_pfm(os.path.join(root, ds.depth_folder, name + ".pfm"),
                           disp)
        else:
            cv2.imwrite(os.path.join(root, ds.depth_folder, name + ".png"),
                        (disp * 256).astype(np.uint16))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("P0: 60.0 0 41.5 0  0 60.0 32.5 0  0 0 1 0\n")
        f.write("P1: 60.0 0 41.5 -18.0  0 60.0 32.5 0  0 0 1 0\n")
    return root


@pytest.fixture(scope="module")
def tum_root(tmp_path_factory):
    """TUM layout written by cv2: colour rgb/ and 16-bit depth/ named by
    timestamp, the depth stamps 4 ms late, one depth frame missing and an
    unmatched extra one."""
    cv2 = pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("tum") / "rgbd_dataset_freiburg2_xyz")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub))
    for i in range(N_FRAMES + 1):
        t = 1.0 + 0.033 * i
        cv2.imwrite(os.path.join(root, "rgb", f"{t:.6f}.png"),
                    _image((RAW_H, RAW_W, 3), np.uint8))
        if i != 2:
            d = RNG.integers(0, 40000, (RAW_H, RAW_W)).astype(np.uint16)
            cv2.imwrite(os.path.join(root, "depth", f"{t + 0.004:.6f}.png"), d)
    cv2.imwrite(os.path.join(root, "depth", "9.000000.png"),
                np.zeros((RAW_H, RAW_W), np.uint16))
    return root


def _inputs(root, cfg_fn, rig=None, **kw):
    j = jds.Input(root, getattr(jds, cfg_fn)(),
                  rig=None if rig is None else jcam.StereoRig(
                      jcam.Intrinsics(*rig), 0.3), **kw)
    p = pds.Input(root, getattr(pds, cfg_fn)(),
                  rig=None if rig is None else pcam.StereoRig(
                      pcam.Intrinsics(*rig), 0.3), **kw)
    return j, p


def _same_frames(fj, fp):
    assert fj.keys() == fp.keys()
    assert fj["timestamp"] == fp["timestamp"]
    for k in ("left", "right", "depth"):
        a, b = fj[k], fp[k]
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def _same_inputs(j, p, prefetch=False):
    assert tuple(j.rig.intr) == tuple(p.rig.intr)
    assert j.rig.baseline_m == p.rig.baseline_m
    assert j.frames == p.frames
    if prefetch:
        fjs, fps = list(j.prefetch_iter()), list(p.prefetch_iter())
    else:
        fjs, fps = list(j), list(p)
    assert len(fjs) == len(fps) > 0
    for fj, fp in zip(fjs, fps):
        _same_frames(fj, fp)
    return fps


@pytest.mark.parametrize("backend", ["cv2", "native"])
@pytest.mark.parametrize("case", [
    dict(),
    dict(rig=tuple(CROP)),
    dict(rig=tuple(CROP), input_scale=0.5),
    dict(rig=tuple(CROP), frame_offset=1, frame_limit=3),
    dict(rig=tuple(CROP), use_color=True),
], ids=["calib", "crop", "scale_half", "offset_limit", "colour"])
def test_input_kitti_equals_jax(kitti_root, backend, case):
    if backend == "native":
        pytest.importorskip("cv2")
    kw = dict(case)
    rig = kw.pop("rig", None)
    j, p = _inputs(kitti_root, "kitti_odometry_config", rig, io_backend=backend,
                   **kw)
    frames = _same_inputs(j, p)
    want = (N_FRAMES - kw.get("frame_offset", 0)
            if "frame_limit" not in kw else kw["frame_limit"])
    assert len(frames) == want
    # disparity -> depth: fx * B / disparity where the disparity > 0.1
    assert (frames[0]["depth"] > 0).mean() > 0.5


@pytest.mark.parametrize("backend", ["cv2", "native"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_input_tum_equals_jax(tum_root, backend, scale):
    j, p = _inputs(tum_root, "tum_config", tuple(CROP), io_backend=backend,
                   input_scale=scale)
    frames = _same_inputs(j, p)
    # the greedy association pairs every rgb stamp that has a depth stamp
    # within 20 ms: frame 2's depth is missing, the extra one unmatched
    assert len(frames) == N_FRAMES
    assert [f[3] for f in p.frames] == [float(f"{1.0 + 0.033 * i:.6f}")
                                        for i in (0, 1, 3, 4, 5)]
    jd, pd = _inputs(tum_root, "tum_config")
    assert tuple(jd.rig.intr) == tuple(pd.rig.intr) == tuple(
        jds.TUM_INTRINSICS["fr2"])


def test_associate_equals_jax():
    a = list(np.cumsum(RNG.uniform(0.02, 0.05, 40)))
    b = sorted(t + RNG.uniform(-0.03, 0.03) for t in a[::2] + a[5:15])
    assert pds.associate(a, b) == jds.associate(a, b)


@pytest.mark.parametrize("root,cfg_fn", [("kitti_root", "kitti_odometry_config"),
                                         ("tum_root", "tum_config")])
def test_prefetch_iter_equals_jax(request, root, cfg_fn):
    j, p = _inputs(request.getfixturevalue(root), cfg_fn, tuple(CROP))
    _same_inputs(j, p, prefetch=True)


def test_prefetch_iter_skips_input_scale_inherited(kitti_root):
    """JAX's prefetch_iter never applies input_scale's resize: at 0.5 it
    yields frames at the unscaled crop size while the rig is scaled. The
    port yields the same frames."""
    j, p = _inputs(kitti_root, "kitti_odometry_config", tuple(CROP),
                   input_scale=0.5)
    frames = _same_inputs(j, p, prefetch=True)
    assert p.rig.intr.width == 40
    assert frames[0]["left"].shape == (60, 80)


def test_native_backend_colour_differs_from_cv2_inherited(tum_root):
    """The native backend decodes colour as RGB where the cv2 path gives
    BGR, and converts it to gray in float (0.299 / 0.587 / 0.114, no
    rounding) where the cv2 path uses cv2's fixed-point rule: the two
    backends give different pixels for colour input, in both packages
    alike."""
    out = {}
    for backend in ("cv2", "native"):
        for colour in (False, True):
            j, p = _inputs(tum_root, "tum_config", tuple(CROP),
                           io_backend=backend, use_color=colour)
            out[backend, colour] = _same_inputs(j, p)[0]["left"]
    gray_cv2, gray_native = out["cv2", False], out["native", False]
    assert not np.array_equal(gray_cv2, gray_native)
    assert np.abs(gray_cv2 - gray_native).max() <= 1.0
    assert np.array_equal(out["native", True], out["cv2", True][..., ::-1])


def test_use_color_frames_are_bgr_and_gray_swaps_r_b_inherited(tum_root):
    """With use_color, frames come in cv2's BGR order, and the consumers
    (DenseSLAM.process_frame, the command line's chunk path) hand them to
    rgb_to_gray as RGB: its R weight lands on B. Both packages alike."""
    import jax.numpy as jnp

    from denseslam_tpu.utils.image import rgb_to_gray as jgray
    from denseslam_tpu_torch.utils.image import rgb_to_gray as pgray

    j, p = _inputs(tum_root, "tum_config", tuple(CROP), use_color=True)
    bgr = _same_inputs(j, p)[0]["left"]
    path = p.frames[0][0]
    assert np.array_equal(bgr.astype(np.uint8), png.read_png(path)[
        3:63, 2:82])
    got = pgray(torch.tensor(bgr)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgray(jnp.asarray(bgr))))
    swapped = (bgr[..., 0] * np.float32(0.299) + bgr[..., 1]
               * np.float32(0.587) + bgr[..., 2] * np.float32(0.114))
    np.testing.assert_allclose(got, swapped, rtol=1e-6)
    true_gray = (bgr[..., 2] * np.float32(0.299) + bgr[..., 1]
                 * np.float32(0.587) + bgr[..., 0] * np.float32(0.114))
    assert np.abs(got - true_gray).max() > 1.0


# -- trajectories, camera, timers ---------------------------------------------

def _poses(n):
    from scipy.spatial.transform import Rotation
    out = []
    for R in Rotation.random(n, random_state=3).as_matrix():
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = RNG.standard_normal(3) * 10
        out.append(T)
    # half turns about each axis: Shepperd's three branches without qw
    for axis in range(3):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = -np.eye(3)
        T[axis, axis] = 1.0
        out.append(T)
    return out


def test_trajectory_writers_byte_for_byte(tmp_path):
    poses = _poses(24)
    stamps = [1.5 + 0.1 * i for i in range(len(poses))]
    ptraj.save_tum(str(tmp_path / "p.txt"), list(zip(stamps, poses)))
    jtraj.save_tum(str(tmp_path / "j.txt"), list(zip(stamps, poses)))
    ptraj.save_kitti(str(tmp_path / "pk.txt"), poses)
    jtraj.save_kitti(str(tmp_path / "jk.txt"), poses)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "pk.txt").read_bytes() == (tmp_path / "jk.txt").read_bytes()
    back = ptraj.load_tum(str(tmp_path / "p.txt"))
    for (t, T), ts, P in zip(back, stamps, poses):
        assert abs(t - ts) < 1e-6
        np.testing.assert_allclose(T[:3, :3], P[:3, :3], atol=1e-6)
    for T, P in zip(ptraj.load_kitti(str(tmp_path / "pk.txt")), poses):
        np.testing.assert_allclose(T[:3, :4], P[:3, :4], atol=1e-6)


def test_quaternion_round_trip():
    for T in _poses(64):
        q = ptraj.rotation_to_quaternion(T[:3, :3])
        np.testing.assert_array_equal(q, jtraj.rotation_to_quaternion(
            T[:3, :3]))
        np.testing.assert_allclose(ptraj.quaternion_to_rotation(q),
                                   T[:3, :3], atol=1e-6)


def test_camera_helpers_equal_jax():
    j = jcam.Intrinsics(707.09, 700.5, 601.89, 183.11, 1226, 370)
    p = pcam.Intrinsics(*j)
    for s in (0.5, 0.7, 0.33):
        assert tuple(p.scaled(s)) == tuple(j.scaled(s))
    np.testing.assert_array_equal(p.k_matrix().numpy(), np.asarray(
        j.k_matrix()))
    d = np.concatenate([RNG.uniform(0, 40, 100), [0.0, 32.767, 32.7675, 99.0,
                                                  0.0005, 0.0015]]).astype(
        np.float32)
    mm = pcam.depth_m_to_mm_i16(torch.tensor(d))
    assert mm.dtype == torch.int16
    np.testing.assert_array_equal(mm.numpy(), np.asarray(
        jcam.depth_m_to_mm_i16(d)))
    np.testing.assert_array_equal(pcam.depth_mm_i16_to_m(mm).numpy(),
                                  np.asarray(jcam.depth_mm_i16_to_m(
                                      np.asarray(mm.numpy()))))


def test_in_bounds_equals_jax():
    j = jcam.Intrinsics(707.09, 700.5, 601.89, 183.11, 1226, 370)
    p = pcam.Intrinsics(*j)
    uv = np.concatenate([RNG.uniform(-20, 1250, (200, 2)),
                         [[0.0, 0.0], [1225.0, 369.0], [1225.5, 3.0],
                          [2.0, 2.0], [1223.0, 367.0]]]).astype(np.float32)
    for margin in (0.0, 2.0):
        got = pcam.in_bounds(torch.tensor(uv), p, margin).numpy()
        want = np.asarray(jcam.in_bounds(uv, j, margin))
        np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_render_stereo_equals_jax():
    """io/synthetic.py render_stereo: one pose's left and right images and
    left depth, equal to the port's batched render of that pose bit for
    bit, and to JAX's render_stereo within the renderer's tolerance of
    tests/test_torch_slice.py (depth within 1e-4 relative on >= 99.9% of
    the pixels that see something; intensities within 0.1 on >= 99.5%,
    within 5 on >= 99.9%: XLA contracts FMAs in the hit point)."""
    from denseslam_tpu.config import tiny_test_config
    from denseslam_tpu.io import synthetic as js
    from denseslam_tpu_torch.io import synthetic as ps
    cfg = tiny_test_config(width=96, height=72)
    T = js.make_trajectory(3, step_m=0.1, yaw_rate=0.02)[2]
    prig = pcam.StereoRig(pcam.Intrinsics(*cfg.rig.intr), cfg.rig.baseline_m)
    want = [np.asarray(a) for a in js.render_stereo(T, cfg.rig)]
    got = [a.numpy() for a in ps.render_stereo(T, prig, device="cpu")]
    batched = ps.render_stereo_trajectory(T[None], prig, device="cpu")
    for g, b in zip(got, batched):
        np.testing.assert_array_equal(g, b[0].numpy())
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape == (72, 96)
        err = np.abs(g - w)
        assert (err <= 0.1).mean() >= 0.995 and (err <= 5.0).mean() >= 0.999
    seen = want[2] > 0
    assert seen.mean() > 0.5
    assert (np.abs(got[2] - want[2])[seen]
            <= 1e-4 * want[2][seen]).mean() >= 0.999


def test_timer_stack_semantics_on_the_cpu():
    """Nesting, means, the mismatch and empty-stack errors and the report's
    format, as the JAX TimerStack has them; on the CPU the intervals are
    host times, which `toc` returns."""
    t = ptiming.TimerStack()
    ref = jtiming.TimerStack()
    for stack in (t, ref):
        stack.tic("outer")
        stack.tic("inner")
        assert stack.toc("inner") >= 0.0
        with pytest.raises(RuntimeError, match="Timer mismatch"):
            stack.toc("inner")
        stack.tic("outer")
        stack.toc()
        with pytest.raises(RuntimeError, match="empty stack"):
            stack.toc()
    with t.scope("scoped") as r:
        r["sync"] = torch.zeros(3)
    assert t.mean_ms("scoped") >= 0.0 and t.mean_ms("missing") == 0.0
    assert t.last_ms("inner") == t.last_lap("inner").ms()
    # a mismatched toc pops the timer it names wrongly
    assert t._counts == {**ref._counts, "scoped": 1} == {
        "inner": 1, "outer": 1, "scoped": 1}
    import re
    shape = lambda r: re.sub(r"[0-9.]+", "#", r)  # noqa: E731
    lines = t.report().splitlines()
    assert [ln.split()[0] for ln in lines] == ["inner", "outer", "scoped"]
    assert [shape(ln) for ln in lines[:2]] == [
        shape(ln) for ln in ref.report().splitlines()]
    assert t.mean_ms("outer") == t.last_ms("outer")
    t.reset()
    assert t.report() == ""
