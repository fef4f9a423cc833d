from text2video.ops.interp import PosePlan, plan_pose_track, synthesize_host, synthesize_device
from text2video.ops.smooth import smooth_host, smooth_device, smooth_device_jit

__all__ = [
    "PosePlan",
    "plan_pose_track",
    "synthesize_host",
    "synthesize_device",
    "smooth_host",
    "smooth_device",
]
