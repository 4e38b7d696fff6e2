"""Multi-GPU screen-tile rendering over ``torch.distributed`` (the port of
``paperrenderer_tpu/parallel``): a mesh of ranks, one screen tile each."""

from .launch import spawn_ranks
from .mesh import TileMesh, make_tile_mesh
from .tiles import (
    gather_tiles,
    make_sharded_hybrid_frame,
    make_sharded_rt_frame,
    measure_sharded_demand,
    sharded_render_frame,
    sharded_render_frame_static,
)

__all__ = [
    "TileMesh",
    "gather_tiles",
    "make_tile_mesh",
    "make_sharded_hybrid_frame",
    "make_sharded_rt_frame",
    "measure_sharded_demand",
    "sharded_render_frame",
    "sharded_render_frame_static",
    "spawn_ranks",
]
