"""The port's live viewer (denseslam_tpu_torch/io/viewer.py, with io/draw.py
and io/mjpeg.py in place of cv2) against the JAX package's
(denseslam_tpu/io/viewer.py, whose module imports no JAX and draws and
records with cv2). `DenseSLAM.last_flow`, which feeds the scene-flow
pane, is held to the JAX VO programs that set it beside the compiles of
those programs: tests/test_torch_frame.py (stereo), tests/test_torch_rgbd.py
(RGB-D) and tests/test_torch_mono.py (mono).

Tolerances, and why:
  * colorize_depth, _OrbitCam.pose / nav, freeview_pose and the pane PNGs'
    pixels: bit for bit (the same numpy);
  * draw_features / draw_flow: bit for bit against cv2's LINE_AA line and
    circle, strokes clipped at the borders included;
  * the /state JSON: the same keys, and the same values but uptime;
  * the record round trip of tests/test_viewer.py:48-90 on the port; its
    .avi read back by cv2.VideoCapture: the frame count and size, and each
    frame's PSNR to its source no more than 1 dB below that of the same
    frames through cv2.VideoWriter's MJPG (observed: above it); the RIFF
    holds one `00dc` JPEG chunk (FFD8 ... FFD9) per recorded frame;
"""

import json
import os
import struct
import urllib.request

import numpy as np
import pytest
import torch

from denseslam_tpu.io import viewer as jv
from denseslam_tpu_torch.io import viewer as pv

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


def test_colorize_depth_equals_jax():
    rng = np.random.default_rng(0)
    d = rng.uniform(-5, 60, (37, 53)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.2] = 0.0
    for max_depth in (30.0, 10.0):
        np.testing.assert_array_equal(pv.colorize_depth(d, max_depth),
                                      jv.colorize_depth(d, max_depth))


def test_orbit_cam_equals_jax():
    a, b = jv._OrbitCam(), pv._OrbitCam()
    steps = [dict(daz=0.7, delv=-0.3, scale=1.5), dict(delv=99.0),
             dict(scale=1e9), dict(dpx=0.1, dpy=-0.2), dict(follow=True),
             dict(scale=1e-9, daz=-2.0), dict(reset=True),
             dict(dpx=-0.05, scale=0.9)]
    for kw in steps:
        a.nav(**kw)
        b.nav(**kw)
        np.testing.assert_array_equal(b.pose(), a.pose())
        assert (b.az, b.el, b.radius, b.follow, b.dirty) == \
            (a.az, a.el, a.radius, a.follow, a.dirty)
        np.testing.assert_array_equal(b.target, a.target)


def _marks(rng, n, h, w):
    uv = rng.uniform(-4, [w + 4, h + 4], (n, 2))
    # Python's round() rounds half to even: put some on .5
    uv[: n // 8] = np.floor(uv[: n // 8]) + 0.5
    return uv, rng.uniform(size=n) > 0.2


@pytest.mark.parametrize("shape", [(60, 80), (61, 97, 3)])
def test_draw_features_equals_cv2(shape):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    uv, valid = _marks(rng, 300, shape[0], shape[1])
    got = pv.draw_features(img, uv, valid)
    want = jv.draw_features(img, uv, valid)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(60, 80), (61, 97, 3)])
def test_draw_flow_equals_cv2(shape):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    uv_prev, valid = _marks(rng, 300, shape[0], shape[1])
    uv_curr = uv_prev + rng.normal(0, 12, uv_prev.shape)
    got = pv.draw_flow(img, uv_prev, uv_curr, valid)
    want = jv.draw_flow(img, uv_prev, uv_curr, valid)
    np.testing.assert_array_equal(got, want)


def _drive(v, record_dir):
    """The steps of tests/test_viewer.py:48-90 on viewer `v`; returns what
    each step gave."""
    seen = {}
    T = np.eye(4)
    T[:3, 3] = [1.0, 0.0, 5.0]
    v.update(pose=T)
    seen["unwatched"] = v.freeview_pose()
    _get(v.port, "/state")
    T2 = T.copy()
    T2[:3, 3] = [2.0, 0.0, 6.0]
    v.update(pose=T2)
    seen["moved"] = v.freeview_pose()
    seen["again"] = v.freeview_pose()
    _get(v.port, "/freeview/nav?daz=0.5&scale=0.8")
    seen["nav"] = v.freeview_pose()
    msg = json.loads(_get(v.port, "/record?action=start&pane=freeview"))
    img = np.random.default_rng(0).random((60, 80)) * 255
    v.update(panes={"freeview": img})
    v.update(panes={"freeview": img * 0.5},
             stats=dict(frame=3, fps=2.5, blocks=10, memory_mb=1.5,
                        tracking_ok=True, keyframes=None))
    v.update(panes={"other": img})
    seen["state"] = json.loads(_get(v.port, "/state"))
    seen["stop"] = json.loads(_get(v.port, "/record?action=stop"))
    seen["path"] = msg["path"]
    seen["start"] = msg
    seen["pane"] = _get(v.port, "/pane/freeview")
    seen["missing"] = None
    try:
        _get(v.port, "/pane/nothing")
    except urllib.error.HTTPError as e:
        seen["missing"] = e.code
    seen["page"] = _get(v.port, "/")
    seen["frames"] = [img, img * 0.5]
    return seen


@pytest.fixture(scope="module")
def roundtrip(tmp_path_factory):
    out = {}
    for name, mod in (("jax", jv), ("port", pv)):
        d = str(tmp_path_factory.mktemp(name))
        v = mod.LiveViewer(port=0, record_dir=d)
        try:
            out[name] = _drive(v, d)
        finally:
            v.close()
    return out


def test_viewer_freeview_rules_equal_jax(roundtrip):
    got, want = roundtrip["port"], roundtrip["jax"]
    assert got["unwatched"] is None and want["unwatched"] is None
    assert got["again"] is None and want["again"] is None
    for k in ("moved", "nav"):
        assert got[k].shape == (4, 4)
        np.testing.assert_array_equal(got[k], want[k])
    assert not np.allclose(got["nav"], got["moved"])


def test_viewer_state_equals_jax(roundtrip):
    got, want = roundtrip["port"]["state"], roundtrip["jax"]["state"]
    assert set(got) == set(want)
    for k in got:
        if k != "uptime_s":
            assert got[k] == want[k], k
    assert got["recording"] == "freeview" and got["recorded_frames"] == 2
    assert got["freeview"]["follow"] is True
    for k in ("start", "stop"):
        a, b = roundtrip["port"][k], roundtrip["jax"][k]
        assert set(a) == set(b) and a["frames"] == b["frames"]
    assert roundtrip["port"]["missing"] == roundtrip["jax"]["missing"] == 404


def test_viewer_pages_and_panes_equal_jax(roundtrip):
    got, want = roundtrip["port"], roundtrip["jax"]
    assert got["page"] == want["page"]
    assert got["pane"][:4] == b"\x89PNG"
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(got["pane"], np.uint8),
                     cv2.IMREAD_UNCHANGED),
        cv2.imdecode(np.frombuffer(want["pane"], np.uint8),
                     cv2.IMREAD_UNCHANGED))


def _psnr(a, b):
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(255.0 ** 2 / err)


def _read_avi(path):
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return n, size, frames


def riff_chunks(path):
    """The `00dc` chunks of an AVI's `movi` list and its `idx1` count."""
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    i = data.index(b"movi") + 4
    chunks = []
    while data[i:i + 4] == b"00dc":
        n = struct.unpack("<I", data[i + 4:i + 8])[0]
        chunks.append(data[i + 8:i + 8 + n])
        i += 8 + n + (n & 1)
    assert data[i:i + 4] == b"idx1"
    return chunks, struct.unpack("<I", data[i + 4:i + 8])[0] // 16


def test_record_reads_back_as_mjpg(roundtrip, tmp_path):
    rt = roundtrip["port"]
    path = rt["path"]
    assert path.endswith(".avi") and os.path.getsize(path) > 0
    n, size, frames = _read_avi(path)
    assert n == len(frames) == 2 and size == (80, 60)
    src = [np.repeat(np.clip(f, 0, 255).astype(np.uint8)[..., None], 3, -1)
           for f in rt["frames"]]
    ref = str(tmp_path / "cv2.avi")
    w = cv2.VideoWriter(ref, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (80, 60))
    for f in src:
        w.write(f)
    w.release()
    _, _, cv2_frames = _read_avi(ref)
    for got, want, s in zip(frames, cv2_frames, src):
        assert _psnr(got, s) >= _psnr(want, s) - 1.0
    chunks, indexed = riff_chunks(path)
    assert len(chunks) == indexed == 2
    assert all(c[:2] == b"\xff\xd8" and c[-2:] == b"\xff\xd9" for c in chunks)


def test_jpeg_frames_match_the_standard_tables():
    """A frame of the recorder decodes (cv2.imdecode) to within cv2's own
    JPEG error at quality 95, and carries libjpeg's quality-95 tables."""
    from denseslam_tpu_torch.io import mjpeg
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:45, 0:70]
    img = np.stack([xx * 3.0, yy * 5.0, (xx + yy) * 2.0], -1) % 256
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    ours = mjpeg.encode_jpeg(img)
    ok, theirs = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    dec = cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_COLOR)
    assert dec.shape == img.shape
    assert _psnr(dec, img) >= _psnr(cv2.imdecode(theirs, 1), img) - 1.0

    def segments(b, marker):
        out, i = [], 2
        while b[i + 1] != 0xDA:
            n = int.from_bytes(b[i + 2:i + 4], "big")
            if b[i + 1] == marker:
                out.append(bytes(b[i + 4:i + 2 + n]))
            i += 2 + n
        return out
    theirs = bytes(theirs)
    for marker in (0xDB, 0xC4):       # DQT, DHT
        assert b"".join(segments(ours, marker)) == \
            b"".join(segments(theirs, marker))


def test_pane_png_equals_cv2():
    rng = np.random.default_rng(4)
    for img in (rng.integers(0, 256, (21, 34, 3)).astype(np.uint8),
                rng.uniform(-20, 300, (21, 34)),
                rng.integers(0, 65536, (9, 7)).astype(np.uint16)):
        got = cv2.imdecode(np.frombuffer(pv._encode_png(img), np.uint8),
                           cv2.IMREAD_UNCHANGED)
        want = cv2.imdecode(np.frombuffer(jv._encode_png(img), np.uint8),
                            cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want)
