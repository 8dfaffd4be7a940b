"""The HMR 2.0 training step's share of the card's bfloat16 peak (%): the
model FLOPs of a training image (`portbench/work/vit.py`: the ViT and head
x3 less the patch convolution's input gradient, SMPL x4) times the window's
images a second (the host clock's rate), over 989 TFLOP/s."""

from portbench import work
from portbench.work import vit


def read(data):
    per_image = vit.train_flops_per_image(data["config"])
    return 100.0 * per_image * data["window"]["images_per_s"] / work.BF16_FLOP_PER_S
