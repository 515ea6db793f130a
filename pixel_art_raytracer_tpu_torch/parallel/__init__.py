"""Sharded rendering and training over ``torch.distributed``: frames x rows
(``mesh``), the entity list (``entity_sharded``), and a local launcher
(``launch.run_ranks``)."""

from .entity_sharded import (entity_axis, envelope_ok, make_entity_mesh,
                             render_frame_entity_sharded)
from .mesh import (Mesh, frame_axis, make_mesh, render_frames_sharded,
                   render_frames_shardmap, row_axis, sharded_train_step)

__all__ = ["Mesh", "make_mesh", "render_frames_sharded",
           "render_frames_shardmap", "sharded_train_step",
           "frame_axis", "row_axis",
           "make_entity_mesh", "render_frame_entity_sharded", "entity_axis",
           "envelope_ok"]
