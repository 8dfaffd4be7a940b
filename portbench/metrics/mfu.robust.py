"""The training step's share of the card's bfloat16 peak (%): the model
FLOPs of a training image (`portbench/work/flops.py`) times the window's
images a second (the host clock's rate), over 989 TFLOP/s. The raster's
share of the FLOPs counts the pairs of the traced stretch's bodies, the
prediction's taken with the weights after the stretch."""

from portbench import work
from portbench.work import flops


def read(data):
    c = data["config"]
    theta = 24 * (6 if c["ief"]["rotation"] == "rot6d" else 3) + 13
    per_image = flops.train_flops_per_image(c["encoder"]["depth"], c["image_size"], theta,
                                            data["extras"]["raster_fmas_per_image"])
    return 100.0 * per_image * data["window"]["images_per_s"] / work.BF16_FLOP_PER_S
