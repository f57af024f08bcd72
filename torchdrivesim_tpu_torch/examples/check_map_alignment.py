"""
Map QA: stopline / lanelet alignment (counterpart of the reference's
``examples/check_map_alignment.py``): prints the stoplines oriented against
their lanelet's direction (``map.find_wrong_way_stoplines``) and bakes the
map with the stoplines drawn over it at 2 px/m on ``--device``
(``ops.rasterize.bake_background_texture``: HF on the card), flipped so that
north is up and written as a uint8 (H, W, 3) ``frame`` to an ``.npz``.

    python -m torchdrivesim_tpu_torch.examples.check_map_alignment --map carla_Town02
"""
import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--map', default='carla_Town02')
    parser.add_argument('--out', default='map_alignment.npz')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Tuple[np.ndarray, List[int]]:
    """Write the image; returns it (uint8) and the wrong-way stoplines' ids."""
    from torchdrivesim_tpu_torch.map import find_map_config, find_wrong_way_stoplines
    from torchdrivesim_tpu_torch.mesh import (
        BaseMesh, BirdviewMesh, build_verts_faces_from_bounding_box, rendering_mesh,
        set_colors_with_defaults)
    from torchdrivesim_tpu_torch.ops.box import box2corners
    from torchdrivesim_tpu_torch.ops.rasterize import bake_background_texture
    from torchdrivesim_tpu_torch.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    args = parse_args(argv)
    cfg_map = find_map_config(args.map)
    if cfg_map is None or cfg_map.road_mesh is None:
        raise SystemExit(f"map {args.map} not found or has no mesh")
    wrong = find_wrong_way_stoplines(cfg_map)
    stoplines = cfg_map.stoplines
    print(f"{args.map}: {len(stoplines)} stoplines, {len(wrong)} wrong-way: {wrong}")
    meshes = [cfg_map.road_mesh]
    if stoplines:
        pos = torch.tensor([[[s.x, s.y, s.length, s.width, s.orientation]
                             for s in stoplines]], dtype=torch.float32)
        verts, faces = build_verts_faces_from_bounding_box(box2corners(pos)[0].numpy())
        meshes.append(rendering_mesh(BaseMesh(verts=verts, faces=faces),
                                     category='traffic_light_red'))
    rgb = set_colors_with_defaults(BirdviewMesh.concat(meshes), get_default_color_map(),
                                   get_default_rendering_levels())
    dev = torch.device(args.device)
    texture = bake_background_texture(
        torch.as_tensor(np.asarray(rgb.verts[0]), device=dev),
        torch.as_tensor(np.asarray(rgb.faces[0]), device=dev),
        torch.as_tensor(np.asarray(rgb.attrs[0]), device=dev),
        background_color=torch.zeros(3, device=dev), pixels_per_meter=2.0)
    img = (texture.data.cpu().numpy()[::-1] * 255).astype(np.uint8)
    np.savez(args.out, frame=img)
    print(f"wrote {args.out}")
    return img, wrong


if __name__ == '__main__':
    main()
