from tpuvo_torch.engine.state import VOState
from tpuvo_torch.engine.vo import bootstrap, run_sequence, track_step

__all__ = ["VOState", "bootstrap", "run_sequence", "track_step"]
