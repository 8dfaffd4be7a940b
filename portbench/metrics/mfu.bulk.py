"""A served crop's share of the card's bfloat16 peak (%): the forward's
model FLOPs (`portbench/work/flops.py`) times the window's crops a second
(the host clock's rate), over 989 TFLOP/s."""

from portbench import work
from portbench.work import flops


def read(data):
    c = data["config"]
    theta = 24 * (6 if c["ief"]["rotation"] == "rot6d" else 3) + 13
    per_image = flops.serve_flops_per_image(c["encoder"]["depth"], c["image_size"], theta)
    return 100.0 * per_image * data["window"]["images_per_s"] / work.BF16_FLOP_PER_S
