"""Device time of the SLAM step's graph with the local BA, in ms per
replay: the union of the device activity that the graph launches made
inside the program's ``tpuvo.replay.slam_step.ba`` spans in the traced
slice, over the number of those spans.  None where there is none."""

from vobench.program_spans import replay_device_ms


def read(ctx):
    return replay_device_ms(ctx["trace"], "slam_step.ba")
