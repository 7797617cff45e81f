from vgpmp_torch.sdf.grid import SdfGrid, distance, nearest_distance, trilinear_distance

__all__ = ["SdfGrid", "nearest_distance", "trilinear_distance", "distance"]
