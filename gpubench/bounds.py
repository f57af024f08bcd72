"""
The card's published peaks and the bound arithmetic of the kernels'
roofline shares, frozen here from ``chip_smoke.py`` (``bound``,
``prim_valid``, ``tile_pairs``, ``soft_tile_pairs``, ``accum_bound`` and
their per-pair operation counts).

Every count is made from the scene: the screen-space corners of the
primitives and faces, the pixels, and the bytes each input needs read once
and each output written once. Nothing is taken from a kernel's cull lists or
prepared operands, so a later kernel is held to the same work whatever
implements it.
"""
import torch

#: NVIDIA H100 SXM data sheet, at 700 W: HBM at 3.35 TB/s; float32 at 67
#: TFLOP/s outside the tensor cores, counting a fused multiply-add as two
#: operations. The kernels forbid contraction (round-to-nearest intrinsics),
#: so each add, multiply, min or compare issues on its own, at half that
#: rate. exp and reciprocals run on the special-function units: 16 results
#: per SM and clock, 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
SFU_OPS_PER_S = 132 * 16 * 1.98e9

#: pixels per side of the tiles in which a primitive or face is counted
BOUND_TILE = 16
#: per (pixel, face) of the soft raster's forward, as (ALU, SFU): 3 edge
#: values (4 each), 3 logistics (clamp 2, add; exp and reciprocal on the
#: SFU), their product and minimum (4), the window (3), alpha, weight, 3
#: colour sums (6), den and transparency (3)
SOFT_FWD_OPS, SOFT_FWD_SFU = 39, 6
#: per (pixel, face) of the grouped backward: pass 1 and the prefix pass
#: each evaluate the face terms and the group's product (~29), the
#: descending pass forms and sums 13 gradient terms after evaluating the
#: face terms again (25 + 50)
SOFT_ACCUM_BWD_OPS, SOFT_ACCUM_BWD_SFU = 2 * 29 + 25 + 50, 18


def bound_s(n_bytes: float, n_ops: float, n_sfu: float = 0.0) -> float:
    """The least time (s): the largest of the bytes over HBM, the float32
    ALU operations and the special-function operations (the two units issue
    side by side)."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_INSTR_PER_S,
               n_sfu / SFU_OPS_PER_S)


def prim_valid(corners: torch.Tensor) -> torch.Tensor:
    """(B, N): primitives that are not degenerate (screen-space cross
    product of the first corner's two edges above 1e-9)."""
    e1 = corners[:, :, 1] - corners[:, :, 0]
    e2 = corners[:, :, -1] - corners[:, :, 0]
    return (e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]).abs() > 1e-9


def tile_pairs(corners: torch.Tensor, valid: torch.Tensor, res: int) -> int:
    """(primitive, tile) pairs of a raster that tests a primitive only in
    the BOUND_TILE x BOUND_TILE pixel tiles its bounding box overlaps.
    ``corners`` (B, N, K, 2) screen (row, col); ``valid`` (B, N)."""
    corners = torch.nan_to_num(corners, nan=-1e9)
    lo = torch.ceil(corners.amin(dim=2) - 0.5).clamp(0, res).long()
    hi = torch.floor(corners.amax(dim=2) - 0.5).clamp(-1, res - 1).long()
    tiles = torch.where(lo <= hi, hi // BOUND_TILE - lo // BOUND_TILE + 1, 0).prod(dim=-1)
    return int((tiles * valid).sum())


def soft_tile_pairs(coef: torch.Tensor, res: int) -> int:
    """(camera, face, tile) triples of the BOUND_TILE x BOUND_TILE pixel
    tiles in which a face can contribute: where one of its edge values
    ``t_e = A*px + B*py + C`` is at most -4 at all four extreme pixel
    centres of a tile (the values are affine, so then at every pixel),
    ``min_e t_e <= -4`` puts its window ramp, hence all it adds, at exactly
    0. ``coef`` (B, F, 3, 3) [face, edge, (A, B, C)]."""
    coef = coef.double()
    first = torch.arange(0, res, BOUND_TILE, dtype=torch.float64,
                         device=coef.device) + 0.5
    ends = torch.stack([first, torch.clamp(first + BOUND_TILE - 1, max=res - 0.5)])
    a, b, c = coef[..., 0, None], coef[..., 1, None], coef[..., 2]
    row = torch.maximum(a * ends[0], a * ends[1])
    col = torch.maximum(b * ends[0], b * ends[1])
    top = row[..., :, None] + col[..., None, :] + c[..., None, None]
    return int((top > -4.0).all(dim=2).sum())


def accum_bound_s(coef: torch.Tensor, res: int, backward: bool, shared: int = 0) -> float:
    """B5a's (forward) or B5b's (backward) bound on one frame. Bytes: the
    first ``shared`` faces of every camera (the road mesh, which the scene
    holds once) read once for the whole frame as world triangles (6
    floats), z weight and color (3); each camera's pose and its other faces'
    coefficients (9 floats), z weight and color read once; the five
    per-pixel planes (num 3, den, transp) written or read once; the
    backward reads the inputs twice (its gradients are written).
    Operations: those of the (pixel, face) pairs in which the face can
    contribute."""
    b, f = coef.shape[0], coef.shape[1]
    pairs = soft_tile_pairs(coef, res) * BOUND_TILE * BOUND_TILE
    faces = shared * (6 + 1 + 3) * 4 + b * ((f - shared) * (9 + 1 + 3) * 4
                                            + (4 * 4 if shared else 0))
    planes = b * 5 * res * res * 4
    if backward:
        return bound_s(2 * faces + planes, pairs * SOFT_ACCUM_BWD_OPS,
                       pairs * SOFT_ACCUM_BWD_SFU)
    return bound_s(faces + planes, pairs * SOFT_FWD_OPS, pairs * SOFT_FWD_SFU)


#: per (pixel, face) of the chunked hard raster (B6b): three edge values (4
#: each), three compares and the two z compares of the fold
HARD_CHUNKED_FACE_OPS = 12 + 3 + 2


def hard_bound_s(road_tris: torch.Tensor, quads: torch.Tensor, tris: torch.Tensor,
                 cam_xy: torch.Tensor, cam_sc: torch.Tensor, scale: float, res: int,
                 left_handed: bool, chunk: int = 64) -> float:
    """B6b's bound on one untextured frame of B cameras. Bytes: the road
    mesh's (F, 3, 2) world triangles with their z and color read once for
    the whole frame (the scene holds the map once, whatever the number of
    cameras), each camera's pose, its boxes (two triangles each), direction
    triangles and stoplines (corners, z, color) read once, and the image
    written once (3 float channels; the background is one color, read from
    nowhere). Operations: each face's three edges and z tests in the tiles
    its screen bounding box overlaps. ``quads`` (B, Q, 4, 2) and ``tris``
    (B, T, 3, 2) are in screen space."""
    from gpubench.reference.render import screen
    b = quads.shape[0]
    box_tris = torch.cat([quads[:, :, [0, 1, 2]], quads[:, :, [0, 2, 3]]], dim=1)
    pairs = tile_pairs(box_tris, prim_valid(box_tris), res) \
        + tile_pairs(tris, prim_valid(tris), res)
    f = road_tris.shape[0]
    for s in range(0, b, chunk):
        xy, sc = cam_xy[s:s + chunk], cam_sc[s:s + chunk]
        rt = screen(road_tris.reshape(1, -1, 2).expand(xy.shape[0], -1, -1), xy, sc,
                    scale, res, left_handed).reshape(xy.shape[0], f, 3, 2)
        pairs += tile_pairs(rt, prim_valid(rt), res)
    face_bytes = (6 + 1 + 1) * 4
    n_bytes = f * face_bytes \
        + b * ((box_tris.shape[1] + tris.shape[1]) * face_bytes + 4 * 4) \
        + b * 3 * res * res * 4
    return bound_s(n_bytes, pairs * BOUND_TILE ** 2 * HARD_CHUNKED_FACE_OPS)
