"""The device's idle share (%) over the profiled stretch: 1 - (union of
kernel and copy intervals) / the stretch's wall (the HMR 2.0 training cell)."""


def read(data):
    s = data["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
