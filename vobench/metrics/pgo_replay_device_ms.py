"""Device time of a replay of the pose graph's captured LM iteration, in ms
per replay: the union of the device activity that the graph launches made
inside the program's ``tpuvo.replay.pgo_step`` spans in the traced slice
ran (by correlation id, so work that the card runs after the host has left
the span still counts), over the number of those spans.  None where there
is none."""

from vobench.program_spans import replay_device_ms


def read(ctx):
    return replay_device_ms(ctx["trace"], "pgo_step")
