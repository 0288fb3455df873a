"""Voxel-block hash table over packed int32 keys (port of
denseslam_tpu/ops/hash.py).

Open addressing with linear probing; a key packs a block's (x, y, z)
coordinates into one int32 (10 bits per axis). Insertion resolves
conflicts with scatter-min claim rounds — the lowest query id wins a free
slot — exactly as the JAX version does, so tables agree slot for slot.

No function here reads a value back to the host: drop-mode scatters are
written as `masked_set_`, which needs no count of the masked rows.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

PACK_BITS = 10
PACK_HALF = 1 << (PACK_BITS - 1)
_PACK_MASK = (1 << PACK_BITS) - 1

EMPTY_KEY = 2 ** 30
EMPTY_COORD = -(2 ** 30)   # the coordinate-space sentinel of `coords`
_I32_MAX = 2 ** 31 - 1


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around, the semantics of
    XLA's int32 multiply (C++ leaves signed overflow undefined, so products
    are formed in int64 and wrapped here)."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def masked_set_(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """In place: dst[idx[i]] = src[i] for every i where mask[i] (the JAX
    `dst.at[where(mask, idx, OOB)].set(src, mode="drop")`).

    `idx` must be unique where `mask` holds. Masked-out rows are sent to the
    first kept row's target carrying that row's value (or, with no kept
    row, to row 0 carrying its current value), so every duplicate write is
    identical and the result is deterministic without a host sync."""
    any_kept = mask.any()
    # index_select with a (1,) index: indexing with a 0-d tensor would
    # read it back to the host
    j = torch.argmax(mask.to(torch.int32)).reshape(1)
    tgt = torch.where(any_kept, idx.index_select(0, j)[0].to(torch.int64), 0)
    fill = torch.where(any_kept, src.index_select(0, j)[0], dst[0].to(src.dtype))
    bmask = mask.view(mask.shape + (1,) * (src.dim() - 1))
    idx2 = torch.where(mask, idx.to(torch.int64), tgt)
    src2 = torch.where(bmask, src, fill)
    dst.index_put_((idx2,), src2.to(dst.dtype))
    return dst


def pack_xyz(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
             mask=None) -> torch.Tensor:
    """SoA coords -> packed key; out-of-range or masked -> EMPTY_KEY."""
    xs = x + PACK_HALF
    ys = y + PACK_HALF
    zs = z + PACK_HALF
    lim = 1 << PACK_BITS
    ok = ((xs >= 0) & (xs < lim) & (ys >= 0) & (ys < lim)
          & (zs >= 0) & (zs < lim))
    if mask is not None:
        ok = ok & mask
    key = xs | (ys << PACK_BITS) | (zs << (2 * PACK_BITS))
    return key.masked_fill(~ok, EMPTY_KEY)


def pack_coords(coords: torch.Tensor, mask=None) -> torch.Tensor:
    """(..., 3) int32 coords -> packed keys (out of range or masked ->
    EMPTY_KEY)."""
    return pack_xyz(coords[..., 0], coords[..., 1], coords[..., 2], mask)


def unpack_xyz(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x = (keys & _PACK_MASK) - PACK_HALF
    y = ((keys >> PACK_BITS) & _PACK_MASK) - PACK_HALF
    z = ((keys >> (2 * PACK_BITS)) & _PACK_MASK) - PACK_HALF
    return x, y, z


def unpack_coords(keys: torch.Tensor) -> torch.Tensor:
    """Packed keys -> (..., 3) int32 coords (for small and cold outputs)."""
    return torch.stack(unpack_xyz(keys), dim=-1)


def hash_key(keys: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Murmur-style finalizer over the packed key -> slot index (int32)."""
    assert num_slots & (num_slots - 1) == 0, "table size must be a power of 2"
    h = wrap_i32(keys.to(torch.int64) * -2048144789)        # 0x85ebca6b
    h = h ^ (h >> 13)
    h = wrap_i32(h.to(torch.int64) * -1028477387)           # 0xc2b2ae35
    h = h ^ (h >> 16)
    return h & (num_slots - 1)


class HashTable(NamedTuple):
    """Slot-indexed packed-key table."""
    keys: torch.Tensor    # int32 (S,); EMPTY_KEY marks a free slot

    @property
    def num_slots(self) -> int:
        return self.keys.shape[0]

    @property
    def valid(self) -> torch.Tensor:
        return self.keys != EMPTY_KEY

    @property
    def coords(self) -> torch.Tensor:
        """(S, 3) coords, EMPTY_COORD on free slots (export and debug)."""
        return unpack_coords(self.keys).masked_fill(~self.valid[:, None],
                                                    EMPTY_COORD)


def make_table(num_slots: int, device) -> HashTable:
    return HashTable(keys=torch.full((num_slots,), EMPTY_KEY,
                                     dtype=torch.int32, device=device))


def lookup_keys(table: HashTable, qkeys: torch.Tensor,
                probe_len: int) -> torch.Tensor:
    """Find slots for (N,) packed keys. Returns int32 (N,), -1 when absent."""
    s = table.num_slots
    h = hash_key(qkeys, s)
    valid = qkeys != EMPTY_KEY
    slot = torch.full_like(qkeys, -1)
    found = torch.zeros_like(valid)
    for r in range(probe_len):
        cand = (h + r) & (s - 1)
        ck = table.keys[cand.long()]
        hit = ~found & valid & (ck == qkeys)
        slot = torch.where(hit, cand, slot)
        found = found | hit
    return slot


def lookup(table: HashTable, queries: torch.Tensor,
           probe_len: int) -> torch.Tensor:
    """Coord-space `lookup_keys`: (N, 3) queries -> slots."""
    return lookup_keys(table, pack_coords(queries), probe_len)


def insert_keys(
    table: HashTable,
    qkeys: torch.Tensor,        # (N,) packed keys — MUST be deduplicated
    qmask: torch.Tensor,        # (N,) bool
    probe_len: int,
) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Insert deduplicated keys; find-or-allocate semantics.

    Returns (table, slots (N,), newly_allocated (N,) bool); slots == -1 for
    masked-out queries and for overflow. Updates `table.keys` in place (the
    JAX version returns a new table; callers use the returned one either
    way)."""
    n = qkeys.shape[0]
    s = table.num_slots
    dev = qkeys.device
    qmask = qmask & (qkeys != EMPTY_KEY)
    h = hash_key(qkeys, s)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    big = torch.full((n,), n + 1, dtype=torch.int32, device=dev)
    no_key = torch.full((n,), _I32_MAX, dtype=torch.int32, device=dev)

    keys = table.keys
    slots = torch.full((n,), -1, dtype=torch.int32, device=dev)
    fresh = torch.zeros((n,), dtype=torch.bool, device=dev)
    pending = qmask

    for r in range(probe_len):
        cand = (h + r) & (s - 1)
        cand_l = cand.long()
        ck = keys[cand_l]
        is_match = pending & (ck == qkeys)
        slots = torch.where(is_match, cand, slots)
        pending = pending & ~is_match

        can_claim = pending & (ck == EMPTY_KEY)
        claim = torch.full((s,), n + 1, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, cand_l, torch.where(can_claim, ids, big),
                              reduce="amin")
        won = can_claim & (claim[cand_l] == ids)
        # winners hold distinct, previously empty slots and every key is
        # < EMPTY_KEY, so a scatter-min writes exactly the winners' keys
        keys.scatter_reduce_(0, cand_l, torch.where(won, qkeys, no_key),
                             reduce="amin")
        slots = torch.where(won, cand, slots)
        fresh = fresh | won
        pending = pending & ~won

    return HashTable(keys=keys), slots, fresh


def insert(table: HashTable, queries: torch.Tensor, qmask: torch.Tensor,
           probe_len: int) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Coord-space `insert_keys` of (N, 3) deduplicated coords."""
    return insert_keys(table, pack_coords(queries, qmask), qmask, probe_len)


def free_slots(table: HashTable, slot_idx: torch.Tensor,
               mask: torch.Tensor) -> HashTable:
    """Free the given slots (in place)."""
    empty = torch.full_like(slot_idx, EMPTY_KEY)
    masked_set_(table.keys, slot_idx, empty, mask)
    return table


def free_mask(table: HashTable, slot_mask: torch.Tensor) -> HashTable:
    """Free every slot where slot_mask (S,) is True."""
    return HashTable(keys=table.keys.masked_fill(slot_mask, EMPTY_KEY))


def unique_keys(keys: torch.Tensor,
                cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate packed keys under a static cap with two single-operand
    sorts. Returns (keys (cap,), mask (cap,), total_unique)."""
    s1 = torch.sort(keys).values
    prev = torch.cat([torch.full((1,), -1, dtype=s1.dtype, device=s1.device),
                      s1[:-1]])
    is_first = (s1 != prev) & (s1 != EMPTY_KEY)
    firsts = s1.masked_fill(~is_first, EMPTY_KEY)
    s2 = torch.sort(firsts).values
    out = s2[:cap]
    umask = out != EMPTY_KEY
    total = is_first.to(torch.int32).sum().to(torch.int32)
    return out, umask, total


def unique_coords(coords: torch.Tensor, mask: torch.Tensor,
                  cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coord-space `unique_keys` of (N, 3) coords under mask (N,): returns
    (unique (cap, 3) with EMPTY_COORD past the last, mask (cap,),
    total_unique)."""
    keys, umask, total = unique_keys(pack_coords(coords, mask), cap)
    out = unpack_coords(keys).masked_fill(~umask[:, None], EMPTY_COORD)
    return out, umask, total
