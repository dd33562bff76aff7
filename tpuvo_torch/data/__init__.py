from tpuvo_torch.data.loader import (
    FrameObservations,
    WorldPoints,
    load_camera_config,
    load_sequence,
    load_trajectory,
    load_world_points,
    parse_measurement,
)

__all__ = [
    "FrameObservations",
    "WorldPoints",
    "load_camera_config",
    "load_sequence",
    "load_trajectory",
    "load_world_points",
    "parse_measurement",
]
