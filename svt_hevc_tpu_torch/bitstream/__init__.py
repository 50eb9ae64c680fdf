from .bitwriter import BitWriter, BitReader, rbsp_to_ebsp, ebsp_to_rbsp
from .nal import NalUnitType, wrap_nal, split_annexb

__all__ = [
    "BitWriter", "BitReader", "rbsp_to_ebsp", "ebsp_to_rbsp",
    "NalUnitType", "wrap_nal", "split_annexb",
]
