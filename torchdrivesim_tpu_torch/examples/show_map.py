"""
Render a whole map to an image (counterpart of the reference's
``examples/show_map.py``): the map's background texture, read from the
cache next to the map or baked there on ``--device`` when it is missing
(``benchmark.load_or_bake_texture``: the hard face raster HF on the card),
flipped so that north is up and written as a uint8 (H, W, 3) ``frame`` to an
``.npz``.

    python -m torchdrivesim_tpu_torch.examples.show_map --map carla_Town02 --out map.npz
"""
import argparse
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--map', default='carla_Town02')
    parser.add_argument('--res', type=int, default=1024,
                        help="accepted as the reference's; the texture's own size is written")
    parser.add_argument('--out', default='map.npz')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Write the map's image; returns it (uint8)."""
    from torchdrivesim_tpu_torch.benchmark import load_or_bake_texture
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    args = parse_args(argv)
    cfg_map = find_map_config(args.map)
    if cfg_map is None or cfg_map.road_mesh is None:
        raise SystemExit(f"map {args.map} not found or has no mesh")
    texture = load_or_bake_texture(cfg_map, get_default_color_map(),
                                   get_default_rendering_levels(), device=args.device)
    img = (np.asarray(texture.data)[::-1] * 255).astype(np.uint8)
    np.savez(args.out, frame=img)
    print(f"map {args.map}: texture {img.shape[1]}x{img.shape[0]} -> {args.out}")
    return img


if __name__ == '__main__':
    main()
