"""One ``slam.OnlineSLAM`` session a sequence, fed a frame at a time in a
closed loop (``drive.Session``); checked by copies of the carry around
sampled steps and by every sequence's bootstrap."""

from vobench import drive, program

numbers = drive.numbers


def make(config, traffic, seed, device):
    return drive.Session(config, traffic, seed, device, program, program.SLAMSession)


def control(config, traffic, seed, precision, device):
    return drive.slam_control(config, traffic, seed, precision, device)
