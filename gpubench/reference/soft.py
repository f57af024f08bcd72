"""
The differentiable egocentric view of the untextured map, plainly: the
softmax-blend soft raster (SoftRas's aggregation as TorchDriveSim's
differentiable renderer states it) of the road mesh and the actors.

Per pixel centre p and face f with screen edges e: ``t_e`` is the signed
distance of p to the edge's line (positive inside) over ``sigma``;
``alpha_f = prod_e sigmoid(t_e) * clamp(min_e t_e + 4, 0, 1)``; with
``w_f = alpha_f exp((20 - z_f) / gamma)`` the pixel is
``(1 - T) sum_f w_f c_f / max(sum_f w_f, 1e-8) + T * background``, ``T =
prod_f (1 - alpha_f)``. A face whose ``min_e t_e <= -4`` at a pixel adds
nothing there, so each 16 x 16 tile folds only the faces for which no edge
is below -4 at all of the tile's pixel centres (a conservative float64
test); everything is differentiable PyTorch, and each block of cameras is
recomputed in the backward pass (``torch.utils.checkpoint``) to bound the
memory.
"""
import torch
from torch.utils.checkpoint import checkpoint

from gpubench.reference import render, scene

TILE = 16
Z_BACKGROUND = 20.0


def actor_faces(state: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """(B, 3A, 3, 2) world triangles of the actors: each box as two
    triangles, then its direction triangle, agent by agent."""
    boxes, tris = scene.actor_shapes(state, size)
    t1 = boxes[:, :, [0, 1, 3]]
    t2 = boxes[:, :, [1, 3, 2]]
    b, a = state.shape[:2]
    return torch.stack([t1, t2, tris], dim=2).reshape(b, 3 * a, 3, 2)


def coefficients(corners: torch.Tensor, sigma: float):
    """(B, F, 3, 2) screen (row, col) triangles -> (B, F, 3, 3) edge
    coefficients (A, B, C) with ``t_e = A row + B col + C``; degenerate
    faces get C = -1e9 (nothing anywhere)."""
    a = corners
    b = corners[..., [1, 2, 0], :]
    ex = b[..., 0] - a[..., 0]
    ey = b[..., 1] - a[..., 1]
    area = (ex[..., 0] * (a[..., 2, 1] - a[..., 0, 1])
            - ey[..., 0] * (a[..., 2, 0] - a[..., 0, 0]))
    sign = torch.sign(area)[..., None]
    elen = torch.sqrt(torch.clamp(ex * ex + ey * ey, min=1e-12))
    norm = sign / ((elen + 1e-8) * sigma)
    ok = (torch.abs(area) > 1e-9)[..., None]
    zero = torch.zeros((), dtype=corners.dtype, device=corners.device)
    ca = torch.where(ok, -ey * norm, zero)
    cb = torch.where(ok, ex * norm, zero)
    cc = torch.where(ok, (ey * a[..., 0] - ex * a[..., 1]) * norm,
                     torch.full((), -1e9, dtype=corners.dtype, device=corners.device))
    return torch.stack([ca, cb, cc], dim=-1)


def tile_lists(coef: torch.Tensor, res: int):
    """(index (B, T, K) long, K) per camera and 16 x 16 tile, the faces that
    may add something there (pad entries index one past the last face)."""
    with torch.no_grad():
        c = coef.double()
        first = torch.arange(0, res, TILE, dtype=torch.float64, device=coef.device) + 0.5
        last = torch.clamp(first + TILE - 1, max=res - 0.5)
        a, b, k = c[..., 0, None], c[..., 1, None], c[..., 2, None]
        rows = torch.maximum(a * first, a * last)                 # (B, F, 3, n)
        cols = torch.maximum(b * first, b * last)
        top = rows[..., :, None] + cols[..., None, :] + k[..., None]
        slack = 1e-4 * ((a.abs() * last)[..., :, None] + (b.abs() * last)[..., None, :]
                        + k.abs()[..., None]) + 1e-6
        keep = ~(top <= -4.0 - slack).any(dim=2)                  # (B, F, n, n)
        keep = keep.flatten(2).transpose(1, 2)                    # (B, T, F)
        counts = keep.sum(-1)
        kmax = max(int(counts.max()), 1)
        f = coef.shape[1]
        order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[..., :kmax]
        valid = torch.arange(kmax, device=coef.device) < counts[..., None]
        return torch.where(valid, order, f), kmax


def raster(coef: torch.Tensor, zw: torch.Tensor, color: torch.Tensor, res: int,
           background: torch.Tensor) -> torch.Tensor:
    """(B, 3, res, res) image in [0, 1] from per-face coefficients (B, F, 3,
    3), z weights (1, F) or (B, F) and colors (B, F, 3)."""
    bsz, f = coef.shape[:2]
    idx, kmax = tile_lists(coef, res)
    pad = coef.new_zeros((bsz, 1, 3, 3))
    pad[..., 2] = -1e9
    coef = torch.cat([coef, pad], dim=1)
    zw = torch.cat([zw.expand(bsz, f), zw.new_zeros((bsz, 1))], dim=1)
    color = torch.cat([color.expand(bsz, f, 3), color.new_zeros((bsz, 1, 3))], dim=1)
    n = res // TILE
    tiles = n * n
    flat = idx.reshape(bsz, tiles * kmax)
    g = lambda x: torch.gather(x, 1, flat.reshape(bsz, -1, *([1] * (x.dim() - 2))).expand(
        bsz, tiles * kmax, *x.shape[2:])).reshape(bsz, tiles, kmax, *x.shape[2:])
    cf, w, cl = g(coef), g(zw), g(color)                        # (B, T, K, ...)
    rows = torch.arange(res, dtype=coef.dtype, device=coef.device) + 0.5
    tr = rows.reshape(n, TILE)[:, None, :, None].expand(n, n, TILE, TILE).reshape(tiles, -1)
    tc = rows.reshape(n, TILE)[None, :, None, :].expand(n, n, TILE, TILE).reshape(tiles, -1)
    t = [cf[..., e, 0, None] * tr[:, None] + cf[..., e, 1, None] * tc[:, None]
         + cf[..., e, 2, None] for e in range(3)]                # (B, T, K, P)
    s = [torch.reciprocal(1.0 + torch.exp(-torch.clamp(te, -30.0, 30.0))) for te in t]
    tmin = torch.minimum(torch.minimum(t[0], t[1]), t[2])
    alpha = s[0] * s[1] * s[2] * torch.clamp(tmin + 4.0, 0.0, 1.0)
    wa = alpha * w[..., None]
    num = (wa[:, :, :, None] * cl[..., None]).sum(2)             # (B, T, 3, P)
    den = wa.sum(2)
    transp = torch.prod(1.0 - alpha, dim=2)
    cover = (1.0 - transp)[:, :, None]
    img = cover * num / torch.clamp(den[:, :, None], min=1e-8) \
        + (1.0 - cover) * background[:, None, :, None]
    img = img.reshape(bsz, n, n, 3, TILE, TILE).permute(0, 3, 1, 4, 2, 5)
    return img.reshape(bsz, 3, res, res)


class Frame:
    """The untextured differentiable view of each environment's first
    agent: the road mesh (shared), the actors, the camera on the ego."""

    def __init__(self, road: scene.RoadMesh, res: int, fov: float, left_handed: bool,
                 sigma: float, gamma: float, background=(0, 0, 0), block: int = 8):
        self.road, self.res, self.scale = road, res, 2.0 / fov
        self.left_handed, self.sigma, self.gamma = left_handed, sigma, gamma
        self.block = block
        self.background = background

    def operands(self, state: torch.Tensor, size: torch.Tensor):
        """(coef (B, F, 3, 3), zw (F,) -> broadcast, colors (B, F, 3)) of the
        frame's faces: the road mesh's, then the actors'."""
        dt = state.dtype
        b, a = state.shape[:2]
        ego = state[:, 0]
        cam_xy = ego[:, :2]
        cam_sc = torch.stack([torch.sin(ego[:, 2]), torch.cos(ego[:, 2])], dim=-1)
        world = torch.cat([self.road.tris.to(dt)[None].expand(b, -1, 3, 2),
                           actor_faces(state, size)], dim=1)
        f = world.shape[1]
        screen = render.screen(world.reshape(b, f * 3, 2), cam_xy, cam_sc, self.scale,
                               self.res, self.left_handed).reshape(b, f, 3, 2)
        z = torch.cat([self.road.z, torch.tensor(
            [scene.LEVELS['vehicle']] * 2 + [scene.LEVELS['direction']],
            device=state.device).repeat(a)]).to(dt)
        rgb = torch.cat([self.road.rgb, torch.tensor(
            [scene.COLORS['vehicle']] * 2 + [scene.COLORS['direction']],
            dtype=torch.uint8, device=state.device).repeat(a, 1)]).to(dt) / 255.0
        zw = torch.exp((Z_BACKGROUND - z) / self.gamma)
        return coefficients(screen, self.sigma), zw[None], rgb[None].expand(b, f, 3)

    def _block(self, state, size):
        coef, zw, rgb = self.operands(state, size)
        bg = torch.tensor(self.background, dtype=state.dtype, device=state.device) / 255.0
        return raster(coef, zw, rgb, self.res, bg.expand(state.shape[0], 3)) * 255.0

    def __call__(self, state: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
        """(B, 3, res, res) in [0, 255], differentiable in ``state``."""
        out = []
        for s in range(0, state.shape[0], self.block):
            out.append(checkpoint(self._block, state[s:s + self.block],
                                  size[s:s + self.block], use_reentrant=False))
        return torch.cat(out, dim=0)
