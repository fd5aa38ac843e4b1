"""Stage timers and the event log."""

from visual_sgraphs_tpu_torch.utils.events import EventLog
from visual_sgraphs_tpu_torch.utils.timing import StageTimers

__all__ = ["EventLog", "StageTimers"]
