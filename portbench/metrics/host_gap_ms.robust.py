"""Host gap a step (ms): over the profiled stretch, its wall less the
device's busy time (the union of kernel and copy intervals), per step."""


def read(data):
    s = data["summary"]
    return (s["window_s"] - s["busy_s"]) / s["units"] * 1e3
