"""Utilities (port of ``volume_renderer_tpu.utils``): the stopwatch, the
profiler trace, the program's spans and the phase timer, and training
checkpoints."""

from volume_renderer_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from volume_renderer_tpu_torch.utils.profiling import PhaseTimer, span, spans, trace
from volume_renderer_tpu_torch.utils.stopwatch import Stopwatch

__all__ = ["Stopwatch", "save_checkpoint", "load_checkpoint", "PhaseTimer", "trace", "span",
           "spans"]
