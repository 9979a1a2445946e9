"""``solver.icm.run`` as ``entries/run.py`` serves it, with the check's
``refine_shift_gap`` read against a refinement that starts where the
answer's did.

``compare.gaps`` reads the refinement's shift against the reference's
run of the whole world, whose init may have reached another optimum
than the answer's (the init is chaotic: a few centimetres there move a
shift of a few centimetres by half).  Here the reference redoes the N
windowed-BA sweeps from the answer's own initial poses, with the
answer's final map as the first sweep's map (``refine_from``), and the
number is the median over the frames of the widest pose-component gap
between the answer's refined poses and the redone ones, as a share of
the median of the redone shift (each frame's widest gap between the
redone and the initial poses).  It reads 0 for the reference's own
refinement, 1 for a refinement left out, and about 2 for one that
moves the poses as far the wrong way."""
import numpy as np

from slambench.entries import run
from slambench.reference import compare


def shift_gap(x_init, x, redone) -> float:
    """The refined poses ``x`` against the ``redone`` refinement from the
    same ``x_init``, as a share of the redone shift (inf where a pose is
    not finite or a shape differs)."""
    shift = np.median(compare._per_frame(redone, x_init))
    gap = np.median(compare._per_frame(x, redone)) / max(shift, 1e-9)
    return float(gap) if np.isfinite(gap) else float("inf")


class Entry(run.Entry):
    def numbers(self, k, ans, whole, params):
        got = super().numbers(k, ans, whole, params)
        redone = self.ref.refine_from(self.worlds[k], ans[0], ans[2], ans[3],
                                      params, self.device)
        got["refine_shift_gap"] = shift_gap(ans[0], ans[1], redone)
        return got
