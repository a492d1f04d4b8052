"""Set-up: the seconds the program spent inside its ``setup.*`` spans
(kernel load, quantize, pack, alignment cache, the trainer's state)
before the window opened, each to the later of its host end and its
device time."""

from benchmark import spans

LAYER = "set-up"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(w):
    return spans.setup_seconds(w)
