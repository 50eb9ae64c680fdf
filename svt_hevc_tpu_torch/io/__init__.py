from .yuv import read_yuv420, write_yuv420, read_y4m, Frame

__all__ = ["read_yuv420", "write_yuv420", "read_y4m", "Frame"]
