"""
The untextured bird's-eye view, plainly: an orthographic egocentric camera
over the map's road mesh, with z-priority primitives on top.

Semantics (TorchDriveSim's renderer as the port states it):

* pixel (r, c) of a ``res`` view lies ``forward = (res/2 - (r + .5)) / ppm``
  ahead of the camera and ``left = lh (res/2 - (c + .5)) / ppm`` to its left
  (``lh`` = -1 on left-handed maps), ppm = scale res / 2;
* faces and primitives cover a pixel centre inside them (edges included);
  the lowest priority z is on top, ties to the earlier face or primitive;
  the background is one color.
"""
import torch

def screen(points: torch.Tensor, cam_xy: torch.Tensor, cam_sc: torch.Tensor,
           scale: float, res: int, left_handed: bool) -> torch.Tensor:
    """(B, N, 2) world points -> (B, N, 2) continuous (row, col)."""
    d = points - cam_xy[:, None]
    s, c = cam_sc[:, None, 0], cam_sc[:, None, 1]
    forward = c * d[..., 0] + s * d[..., 1]
    left = -s * d[..., 0] + c * d[..., 1]
    half = res / 2.0
    ppm = scale * half
    row = half - forward * ppm
    col = half + left * ppm if left_handed else half - left * ppm
    return torch.stack([row, col], dim=-1)


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


def cover_quads(corners: torch.Tensor, res: int) -> torch.Tensor:
    """(B, Q, 4, 2) screen corners of parallelograms (cycle order) -> (B, Q,
    res, res) bool: pixel centres with affine coordinates in [0, 1] along
    the edges from corner 0 to corners 1 and 3."""
    p = torch.arange(res, dtype=torch.float32, device=corners.device) + 0.5
    pr, pc = p[:, None], p[None, :]
    c0 = corners[:, :, 0, :, None, None]
    e1 = (corners[:, :, 1] - corners[:, :, 0])[..., None, None]
    e2 = (corners[:, :, 3] - corners[:, :, 0])[..., None, None]
    det = _cross(e1[:, :, 0], e1[:, :, 1], e2[:, :, 0], e2[:, :, 1])
    dr, dc = pr - c0[:, :, 0], pc - c0[:, :, 1]
    u = _cross(dr, dc, e2[:, :, 0], e2[:, :, 1]) / det
    v = _cross(e1[:, :, 0], e1[:, :, 1], dr, dc) / det
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return inside & (det.abs() > 1e-9)


def cover_tris(corners: torch.Tensor, res: int) -> torch.Tensor:
    """(B, T, 3, 2) screen triangles -> (B, T, res, res) bool: pixel centres
    on the inner side of all three edges (either winding)."""
    p = torch.arange(res, dtype=torch.float32, device=corners.device) + 0.5
    pr, pc = p[:, None], p[None, :]
    w = []
    for k in range(3):
        a, b = corners[:, :, k], corners[:, :, (k + 1) % 3]
        e = (b - a)[..., None, None]
        w.append(_cross(e[:, :, 0], e[:, :, 1], pr - a[:, :, 0, None, None],
                        pc - a[:, :, 1, None, None]))
    area = _cross(corners[:, :, 1, 0] - corners[:, :, 0, 0],
                  corners[:, :, 1, 1] - corners[:, :, 0, 1],
                  corners[:, :, 2, 0] - corners[:, :, 0, 0],
                  corners[:, :, 2, 1] - corners[:, :, 0, 1])[..., None, None]
    pos = (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0)
    neg = (w[0] <= 0) & (w[1] <= 0) & (w[2] <= 0)
    return torch.where(area > 0, pos, neg) & (area.abs() > 1e-9)


class Canvas:
    """Z-priority painting over a (B, res, res, 3) uint8 background: per
    pixel the covering primitive of lowest z, ties to the one added first."""

    def __init__(self, image: torch.Tensor):
        self.rgb = image.clone()
        self.key = torch.full(image.shape[:3], torch.inf, dtype=torch.float64,
                              device=image.device)
        self.count = 0

    def add(self, cover: torch.Tensor, z: torch.Tensor, rgb: torch.Tensor,
            batch=slice(None), index=None):
        """Primitives (cover (b, N, res, res) bool, z (b, N), rgb8 (b, N, 3))
        of the cameras ``batch``, numbered from :attr:`count` on (or by
        ``index``) for ties."""
        n = z.shape[1]
        idx = self.count + torch.arange(n, device=z.device, dtype=torch.float64) \
            if index is None else index.to(torch.float64)
        key = z.double() * 1e6 + idx
        key = torch.where(cover, key[..., None, None], torch.inf)
        best, arg = key.min(dim=1)
        color = torch.gather(rgb, 1, arg.flatten(1)[..., None].expand(-1, -1, 3))
        color = color.reshape(best.shape + (3,))
        better = best < self.key[batch]
        self.key[batch] = torch.where(better, best, self.key[batch])
        self.rgb[batch] = torch.where(better[..., None], color, self.rgb[batch])

    def next(self, n: int):
        """Count ``n`` primitives as added (the index of ties)."""
        self.count += n


def frame(state: torch.Tensor, size: torch.Tensor, light_corners: torch.Tensor,
          light_state, cam_xy: torch.Tensor, cam_sc: torch.Tensor, scale: float,
          res: int, left_handed: bool, road, background_rgb8=(0, 0, 0),
          chunk: int = 512) -> torch.Tensor:
    """(B, res, res, 3) uint8 view of each environment from its camera: the
    road mesh under the agents' boxes, the stoplines and the direction
    triangles."""
    from gpubench.reference import scene
    b = state.shape[0]
    image = torch.tensor(background_rgb8, dtype=torch.uint8, device=state.device
                         ).expand(b, res, res, 3)
    canvas = Canvas(image)
    to_screen = lambda p: screen(p.reshape(b, -1, 2), cam_xy, cam_sc, scale, res,
                                 left_handed).reshape(p.shape)
    f = road.tris.shape[0]
    for i in range(b):
        tri = screen(road.tris.reshape(1, -1, 2), cam_xy[i:i + 1], cam_sc[i:i + 1],
                     scale, res, left_handed).reshape(1, f, 3, 2)
        lo, hi = tri.amin(dim=2)[0], tri.amax(dim=2)[0]
        keep = torch.nonzero((hi >= 0).all(-1) & (lo <= res).all(-1))[:, 0]
        for s in range(0, keep.numel(), chunk):
            k = keep[s:s + chunk]
            # a road face's index among the frame's faces is its own
            canvas.add(cover_tris(tri[:, k], res), road.z[k][None], road.rgb[k][None],
                       batch=slice(i, i + 1), index=k)
    canvas.count = f
    (quads, qz, qrgb), (tris, tz, trgb) = scene.prims(state, size, light_corners,
                                                      light_state)
    a = state.shape[1]
    # the order of the frame: each agent's box, then its direction; then the
    # stoplines
    canvas.add(cover_quads(to_screen(quads[:, :a]), res), qz[:, :a], qrgb[:, :a])
    canvas.next(a)
    canvas.add(cover_tris(to_screen(tris), res), tz, trgb)
    canvas.next(a)
    canvas.add(cover_quads(to_screen(quads[:, a:]), res), qz[:, a:], qrgb[:, a:])
    return canvas.rgb
