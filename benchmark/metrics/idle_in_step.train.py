"""Model step: the share of the traced window in which the device was idle
while the host was inside ``train.step``; the rest of
``device_idle.train`` lies between steps."""

from benchmark import spans

LAYER = "model step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "train_tokens_per_s"


def read(w):
    if w.kind != "train":
        return None
    split = spans.idle_split(w, ("train.step",))
    return None if split is None else split.get("train.step", 0.0)
