from text2video.frontend.textnorm import strip_punct, derive_file_name
from text2video.frontend.timestamps import (
    Timestamps,
    parse_timestamp_lines,
    load_timestamp_file,
    format_timestamp_lines,
)

__all__ = [
    "strip_punct",
    "derive_file_name",
    "Timestamps",
    "parse_timestamp_lines",
    "load_timestamp_file",
    "format_timestamp_lines",
]
