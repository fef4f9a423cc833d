from text2video.io.openpose import (
    KeypointFrame,
    load_keypoint_json,
    dump_keypoint_json,
    frame_from_raw,
    raw_with_tracks,
)
from text2video.io.dicts import PoseDictionary, KeypointTable

__all__ = [
    "KeypointFrame",
    "load_keypoint_json",
    "dump_keypoint_json",
    "frame_from_raw",
    "raw_with_tracks",
    "PoseDictionary",
    "KeypointTable",
]
