"""
Convert a Lanelet2 OSM map to the serialized birdview mesh format
(counterpart of the JAX package's ``examples/lanelet2_to_birdview_mesh.py``):
the road mesh triangulated from the lanelets, with the lane-marking mesh
merged into it, written as the JSON that ``BirdviewMesh.load`` reads.

    python -m torchdrivesim_tpu_torch.examples.lanelet2_to_birdview_mesh \\
        --osm path/to/map.osm --out path/to/map_mesh.json --origin 0 0
"""
import argparse
from typing import List, Optional

from torchdrivesim_tpu_torch.lanelet2 import (
    lanelet_map_to_lane_mesh, load_lanelet_map, road_mesh_from_lanelet_map,
)
from torchdrivesim_tpu_torch.mesh import BirdviewMesh


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--osm', required=True)
    parser.add_argument('--out', required=True)
    parser.add_argument('--origin', nargs=2, type=float, default=(0.0, 0.0))
    parser.add_argument('--left-handed', action='store_true')
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> BirdviewMesh:
    """Convert and write the mesh; returns it."""
    args = parse_args(argv)
    lanelet_map = load_lanelet_map(args.osm, origin=tuple(args.origin))
    road = BirdviewMesh.set_properties(road_mesh_from_lanelet_map(lanelet_map),
                                       category='road')
    lanes = lanelet_map_to_lane_mesh(lanelet_map, left_handed=args.left_handed)
    combined = lanes.merge(road)
    combined.save(args.out)
    print(f"{args.osm}: {combined.verts_count} verts, "
          f"{combined.faces_count} faces -> {args.out}")
    return combined


if __name__ == '__main__':
    main()
