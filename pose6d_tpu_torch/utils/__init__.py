from .camera import DEFAULT_K, get_gt_and_K
from .mesh import load_mesh_corners
from .viz import draw_3d_box, draw_axes, draw_rectangle, project_points

__all__ = ["DEFAULT_K", "get_gt_and_K", "load_mesh_corners", "project_points", "draw_3d_box",
           "draw_axes", "draw_rectangle"]
