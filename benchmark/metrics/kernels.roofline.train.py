"""kernels.roofline.train (%): the summed least time of every launch of the
program's kernel entries in the traced window (``benchmark/costs/``) over
the summed device time of the program's kernels there. Silent where a
launched entry has no cost file: its time could not be set against a
bound."""
from benchmark import costs
from benchmark.peaks import bound_s


def read(view):
    if not view.launches:
        return None
    fns, bound = {}, 0.0
    for entry, ints, g in view.launches:
        if entry not in fns:
            fns[entry] = costs.load(entry)
        if fns[entry] is None or g is None:
            return None
        bound += bound_s(*fns[entry](ints, g))
    device = sum(s for _, group, s in view.kernels if group == "port")
    return 100.0 * bound / device if device > 0 else None
