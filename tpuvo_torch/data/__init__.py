from tpuvo_torch.data.loader import FrameObservations, WorldPoints

__all__ = ["FrameObservations", "WorldPoints"]
