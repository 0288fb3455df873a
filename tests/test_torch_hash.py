"""ops/hash.py port vs the JAX table: hashing, dedupe, insert and lookup
must agree slot for slot (the JAX algorithm is deterministic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.ops import hash as jh
from denseslam_tpu_torch.ops import hash as ph


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(coords):
    c = np.asarray(coords, np.int32)
    return np.array(jh.pack_xyz(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]),
                                jnp.asarray(c[:, 2])))


def test_pack_and_hash_match_jax_with_int32_wraparound(rng):
    c = rng.integers(-600, 600, (4096, 3)).astype(np.int32)   # incl. out of range
    mask = rng.random(4096) < 0.9
    jk = np.asarray(jh.pack_xyz(*(jnp.asarray(c[:, i]) for i in range(3)),
                                jnp.asarray(mask)))
    pk = ph.pack_xyz(*(torch.tensor(c[:, i]) for i in range(3)),
                     torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(jk, pk)
    for xyz_j, xyz_p in zip(jh.unpack_xyz(jnp.asarray(jk)),
                            ph.unpack_xyz(torch.tensor(jk))):
        np.testing.assert_array_equal(np.asarray(xyz_j), xyz_p.numpy())
    # full-range keys exercise the multiply wrap-around in both directions
    anyk = rng.integers(-2 ** 31, 2 ** 31, 8192, dtype=np.int64).astype(np.int32)
    for s in (64, 1 << 12, 1 << 17):
        np.testing.assert_array_equal(
            np.asarray(jh.hash_key(jnp.asarray(anyk), s)),
            ph.hash_key(torch.tensor(anyk), s).numpy())


@pytest.mark.parametrize("n,cap", [(600, 256), (300, 1024)])
def test_unique_keys_match_jax(rng, n, cap):
    c = rng.integers(-20, 20, (n, 3))
    k = _keys(c)
    k[rng.random(n) < 0.1] = jh.EMPTY_KEY
    ju, jm, jtot = jh.unique_keys(jnp.asarray(k), cap)
    pu, pm, ptot = ph.unique_keys(torch.tensor(k), cap)
    np.testing.assert_array_equal(np.asarray(ju), pu.numpy())
    np.testing.assert_array_equal(np.asarray(jm), pm.numpy())
    assert int(jtot) == int(ptot)


def _insert_both(slots, k, mask, probe_len, rounds=2):
    jt_, pt_ = jh.make_table(slots), ph.make_table(slots, "cpu")
    for _ in range(rounds):
        jt_, js, jf = jh.insert_keys(jt_, jnp.asarray(k), jnp.asarray(mask),
                                     probe_len)
        pt_, ps, pf = ph.insert_keys(pt_, torch.tensor(k), torch.tensor(mask),
                                     probe_len)
        np.testing.assert_array_equal(np.asarray(jt_.keys), pt_.keys.numpy())
        np.testing.assert_array_equal(np.asarray(js), ps.numpy())
        np.testing.assert_array_equal(np.asarray(jf), pf.numpy())
    return jt_, pt_, ps


@pytest.mark.parametrize("slots,n,probe", [(256, 64, 16), (1 << 12, 900, 16)])
def test_insert_and_lookup_slot_for_slot(rng, slots, n, probe):
    c = rng.integers(-50, 50, (n, 3))
    u, m, _ = jh.unique_keys(jnp.asarray(_keys(c)), n)
    k, mask = np.asarray(u), np.asarray(m) & (rng.random(n) < 0.95)
    jt_, pt_, _ = _insert_both(slots, k, mask, probe)
    q = np.concatenate([k, _keys(rng.integers(-60, 60, (64, 3)))])
    np.testing.assert_array_equal(
        np.asarray(jh.lookup_keys(jt_, jnp.asarray(q), probe)),
        ph.lookup_keys(pt_, torch.tensor(q), probe).numpy())


def test_collision_heavy_insert_slot_for_slot():
    """Tiny table, sequential coords (tests/test_hash.py:81): most probes
    collide and some queries overflow the probe window."""
    n = 40
    c = np.stack([np.arange(n), np.zeros(n), np.zeros(n)], -1)
    u, m, _ = jh.unique_keys(jnp.asarray(_keys(c)), n)
    k, mask = np.asarray(u), np.asarray(m)
    _insert_both(64, k, mask, 32)
    _, _, ps = _insert_both(32, k, mask, 8, rounds=1)   # over-full
    assert (ps == -1).any()


def test_free_slots_and_free_mask_match_jax(rng):
    c = rng.integers(0, 15, (32, 3))
    u, m, _ = jh.unique_keys(jnp.asarray(_keys(c)), 32)
    jt_, js, _ = jh.insert_keys(jh.make_table(128), u, m, 16)
    pt_, ps, _ = ph.insert_keys(ph.make_table(128, "cpu"),
                                torch.tensor(np.asarray(u)),
                                torch.tensor(np.asarray(m)), 16)
    half = np.asarray(m) & (np.arange(32) % 2 == 0)
    jt2 = jh.free_slots(jt_, js, jnp.asarray(half))
    pt2 = ph.free_slots(pt_, ps, torch.tensor(half))
    np.testing.assert_array_equal(np.asarray(jt2.keys), pt2.keys.numpy())
    smask = rng.random(128) < 0.3
    np.testing.assert_array_equal(
        np.asarray(jh.free_mask(jt2, jnp.asarray(smask)).keys),
        ph.free_mask(pt2, torch.tensor(smask)).keys.numpy())


def test_masked_set_is_a_drop_mode_scatter(rng):
    dst = torch.tensor(rng.integers(0, 100, (50, 4)), dtype=torch.int32)
    idx = torch.tensor(rng.permutation(50)[:20], dtype=torch.int32)
    src = torch.tensor(rng.integers(100, 200, (20, 4)), dtype=torch.int32)
    mask = torch.tensor(rng.random(20) < 0.5)
    ref = jnp.asarray(dst.numpy()).at[
        jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(idx.numpy()), 50)
    ].set(jnp.asarray(src.numpy()), mode="drop")
    ph.masked_set_(dst, idx, src, mask)
    np.testing.assert_array_equal(np.asarray(ref), dst.numpy())
    # nothing kept: unchanged
    before = dst.clone()
    ph.masked_set_(dst, idx, src, torch.zeros(20, dtype=torch.bool))
    assert torch.equal(before, dst)


def test_coordinate_api_matches_jax(rng):
    """The coordinate-space names (EMPTY_COORD, pack_coords,
    unpack_coords, HashTable.coords, unique_coords, insert, lookup) equal
    JAX's bit for bit, and keep tests/test_hash.py's properties: every
    inserted block found at its slot, a second insert finds them all, and
    absent coordinates miss."""
    assert ph.EMPTY_COORD == int(jh.EMPTY_COORD)
    c = rng.integers(-600, 600, (512, 3)).astype(np.int32)  # incl. out of range
    mask = rng.random(512) < 0.9
    jk = np.asarray(jh.pack_coords(jnp.asarray(c), jnp.asarray(mask)))
    pk = ph.pack_coords(torch.tensor(c), torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(
        ph.unpack_coords(torch.tensor(jk)).numpy(),
        np.asarray(jh.unpack_coords(jnp.asarray(jk))))

    coords = rng.integers(-50, 50, (96, 3)).astype(np.int32)
    coords[48:] = coords[:48]                                  # duplicates
    m = np.ones(96, bool)
    m[::7] = False
    # jitted: eagerly, every op of the probe rounds compiles on its own
    ju, jm, jt = jax.jit(jh.unique_coords, static_argnums=2)(
        jnp.asarray(coords), jnp.asarray(m), 64)
    pu, pm_, pt_ = ph.unique_coords(torch.tensor(coords), torch.tensor(m), 64)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(pm_.numpy(), np.asarray(jm))
    assert int(pt_) == int(jt)

    jtab, js, jf = jax.jit(jh.insert, static_argnums=3)(jh.make_table(256),
                                                        ju, jm, 16)
    ptab, ps, pf = ph.insert(ph.make_table(256, "cpu"), pu, pm_, 16)
    np.testing.assert_array_equal(ptab.keys.numpy(), np.asarray(jtab.keys))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ptab.coords.numpy(),
                                  np.asarray(jtab.coords))
    live = (pm_ & (ps >= 0)).numpy()
    assert live.sum() == int(pt_)
    np.testing.assert_array_equal(ph.lookup(ptab, pu, 16).numpy()[live],
                                  ps.numpy()[live])
    _, ps2, pf2 = ph.insert(ptab, pu, pm_, 16)
    np.testing.assert_array_equal(ps2.numpy(), ps.numpy())
    assert not pf2.numpy()[pm_.numpy()].any()
    missing = torch.tensor([[100, 100, 100], [-99, 0, 3]], dtype=torch.int32)
    np.testing.assert_array_equal(
        ph.lookup(ptab, missing, 16).numpy(),
        np.asarray(jax.jit(jh.lookup, static_argnums=2)(
            jtab, jnp.asarray(missing.numpy()), 16)))
    assert (ph.lookup(ptab, missing, 16).numpy() == -1).all()
