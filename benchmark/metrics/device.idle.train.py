"""device.idle.train (%): the share of the traced window in which no
operation ran on the device (1 - busy / window; busy is the union of the
device's intervals)."""


def read(view):
    if not view.steps:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
