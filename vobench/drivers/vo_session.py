"""One ``vo.OnlineVO`` session a sequence, fed a frame at a time in a
closed loop (``drive.Session``); checked by the kept sequences' answers and
by every sequence's bootstrap."""

from vobench import drive, program

numbers = drive.numbers


def make(config, traffic, seed, device):
    return drive.Session(config, traffic, seed, device, program, program.Session)


def control(config, traffic, seed, precision, device):
    return drive.vo_control(config, traffic, seed, precision, device, batch=False)
