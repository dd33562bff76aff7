"""``run_batch`` over ``lanes`` problems, one call after another
(``drive.Batch``); checked lane by lane and by every lane's bootstrap."""

from vobench import drive, program

numbers = drive.numbers


def make(config, traffic, seed, device):
    return drive.Batch(config, traffic, seed, device, program)


def control(config, traffic, seed, precision, device):
    return drive.vo_control(config, traffic, seed, precision, device, batch=True)
