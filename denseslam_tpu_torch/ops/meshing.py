"""Mesh extraction from the voxel-hashed TSDF: marching tetrahedra + OBJ
(port of denseslam_tpu/ops/meshing.py).

Each cell between 8 voxel centres splits into 6 tetrahedra around its main
diagonal; the 16-case tet table (1 or 3 corners inside -> one triangle,
2 -> two) is derived in code. Cells on a block's + faces read the
neighbouring blocks through the hash (`sample_tsdf_nearest`). The valid
blocks are meshed `chunk` at a time; each chunk's triangle soup is
compacted on its device and the soups are brought to the host once.
`save_obj` is the JAX version's numpy writer, so the same triangles give
the same file, byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TsdfConfig
from . import hash as vhash
from . import tsdf as tsdf_ops

# 6-tetrahedra decomposition of the unit cube (indices into the 8 cube
# corners, all sharing the main diagonal 0-7). Corner i has offsets
# ((i>>0)&1, (i>>1)&1, (i>>2)&1) in (x, y, z).
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    dtype=np.int32,
)

_CUBE_OFFSETS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
    dtype=np.int32,
)

# Per 4-bit sign case (bit i set = corner i inside, sdf < 0): up to 2
# triangles, each as 3 edges; an edge is a pair (a, b) of tet-corner ids.
#   1 inside  -> tri over the 3 edges from that corner (a=inside corner)
#   3 inside  -> same as 1 outside, winding flipped
#   2 inside  -> quad over the 4 crossing edges -> 2 triangles
_EDGE_TABLE = np.full((16, 2, 3, 2), -1, dtype=np.int32)


def _build_tet_table() -> None:
    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not case & (1 << i)]
        if len(inside) == 1:
            a = inside[0]
            _EDGE_TABLE[case, 0] = np.array([(a, o) for o in outside])
        elif len(inside) == 3:
            a = outside[0]
            e = [(a, i) for i in inside]
            # flip winding relative to the 1-inside case
            _EDGE_TABLE[case, 0] = np.array([e[0], e[2], e[1]])
        else:  # 2 vs 2
            a, b = inside
            c, d = outside
            # crossing edges: (a,c) (a,d) (b,c) (b,d); quad a-c, a-d, b-d, b-c
            _EDGE_TABLE[case, 0] = np.array([(a, c), (a, d), (b, d)])
            _EDGE_TABLE[case, 1] = np.array([(a, c), (b, d), (b, c)])


_build_tet_table()


def _mesh_blocks(m: tsdf_ops.MapState, block_slots: torch.Tensor,
                 cfg: TsdfConfig):
    """Triangles of the cells of the allocated blocks `block_slots` (B,):
    (verts (B, 512, 6, 2, 3, 3), valid (B, 512, 6, 2)). A triangle is
    valid where its tet's case has it and all 4 tet corners are observed
    (weight > 0)."""
    dev = block_slots.device
    vsz = cfg.voxel_size_m
    bx, by, bz = vhash.unpack_xyz(m.table.keys[block_slots.long()])
    bcoords = torch.stack([bx, by, bz], dim=-1)                   # (B, 3)
    offs = torch.stack(tsdf_ops._voxel_off_xyz(dev), dim=-1)      # (512, 3)
    # cell base voxel = block voxel coords; corner k at +_CUBE_OFFSETS[k]
    base = bcoords[:, None, :] * tsdf_ops.BLOCK + offs[None]      # (B, 512, 3)
    corners = (base[:, :, None, :]
               + torch.as_tensor(_CUBE_OFFSETS, device=dev)[None, None])
    cpos = (corners.to(torch.float32) + 0.5) * vsz                # (B, 512, 8, 3)
    sdf, wgt = tsdf_ops.sample_tsdf_nearest(m, cpos, cfg)
    observed = wgt > 0

    tets = torch.as_tensor(_TETS, device=dev).long()              # (6, 4)
    t_sdf = sdf[:, :, tets]                                       # (B, 512, 6, 4)
    t_pos = cpos[:, :, tets, :]                                   # (B, 512, 6, 4, 3)
    t_obs = observed[:, :, tets].all(dim=-1)                      # (B, 512, 6)

    inside = (t_sdf < 0.0).to(torch.int32)
    case = (inside[..., 0] + 2 * inside[..., 1]
            + 4 * inside[..., 2] + 8 * inside[..., 3])            # (B, 512, 6)

    table = torch.as_tensor(_EDGE_TABLE, device=dev)
    tri_edges = table[case.long()]                                # (B, 512, 6, 2, 3, 2)
    tri_valid = tri_edges[..., 0, 0] >= 0                         # (B, 512, 6, 2)
    ea = torch.clamp(tri_edges[..., 0], min=0).long()             # (B, 512, 6, 2, 3)
    eb = torch.clamp(tri_edges[..., 1], min=0).long()

    s4 = t_sdf[:, :, :, None, :].expand(ea.shape[:-1] + (4,))
    sa = torch.gather(s4, 4, ea)
    sb = torch.gather(s4, 4, eb)
    p4 = t_pos[:, :, :, None].expand(ea.shape[:-1] + (4, 3))
    pa = torch.gather(p4, 4, ea[..., None].expand(ea.shape + (3,)))
    pb = torch.gather(p4, 4, eb[..., None].expand(eb.shape + (3,)))
    denom = sa - sb
    big = denom.abs() > 1e-9
    t = torch.where(big, sa / torch.where(big, denom, 1.0), 0.5)
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    verts = pa + (pb - pa) * t                                    # (B, 512, 6, 2, 3, 3)
    return verts, tri_valid & t_obs[..., None]


def extract_mesh(m: tsdf_ops.MapState, cfg: TsdfConfig,
                 chunk: int = 512) -> np.ndarray:
    """The scene mesh as a triangle soup (T, 3, 3) float32, the valid
    blocks taken `chunk` at a time in slot order (each chunk's verts
    tensor holds chunk * 110,592 floats; the JAX version pads its last
    chunk, here it is only shorter). One host read a chunk (the count of
    its triangles) and one at the end."""
    slots = torch.nonzero(m.table.valid).flatten().to(torch.int32)
    tris = []
    for i in range(0, slots.numel(), chunk):
        verts, valid = _mesh_blocks(m, slots[i:i + chunk], cfg)
        tris.append(verts.reshape(-1, 3, 3)[valid.reshape(-1)])
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return torch.cat(tris).cpu().numpy()


def save_obj(path: str, tris: np.ndarray) -> None:
    """Write a triangle soup as OBJ (vertices deduplicated on a 0.1mm grid)."""
    if tris.size == 0:
        with open(path, "w") as f:
            f.write("# empty mesh\n")
        return
    flat = tris.reshape(-1, 3)
    keys = np.round(flat * 1e4).astype(np.int64)
    _, uniq_idx, inv = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[uniq_idx]
    faces = inv.reshape(-1, 3)
    with open(path, "w") as f:
        f.write(f"# denseslam_tpu mesh: {len(verts)} verts, {len(faces)} tris\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")
