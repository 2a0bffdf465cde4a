"""What decides `correct` in a cell over several ranks: the numbers of
`traincheck` taken by the median leaf, and the ranks' agreement.

The reference of the global step (`reference/ranks.py`) runs the whole
batch in one process, while each rank runs its slice: in bf16 the two pick
other kernels for batches of other sizes and sum in another order, and
those roundings, small in each product, move what follows discrete choices
(the matcher's assignment, the best hypothesis) and the camera head's
BatchNorms over few values. In f32 the same program and reference agree to
1e-7 in the first step's loss and 1e-3 in the worst leaf's gradient; in
bf16 the worst leaf reads a tenth or more in sound runs, as the fp8
control does, and the first step's loss up to 8e-3 against the control's
2e-2 to 4e-2. The median leaf's numbers stay steady from seed to seed and
keep the fp8 control a decade away. Compared:

* `grad_gap.median_leaf`: the first gradient as AdamW holds it, the median
  over leaves of each leaf's |norm gap| (over the larger of its reference
  norm and the median leaf's);
* `update_gap`: the median leaf's change over the three steps (as in
  `traincheck`);
* `window.grad_gap.median_leaf`: the window's first step from rank 0's
  state, its gradient by the median leaf;
* the driver's `ranks.param_gap` and `ranks.buffer_gap`: each rank's state
  after the three steps against rank 0's, bit for bit.

Shown but not compared: the single card's numbers (`traincheck.all_gaps`)
and the window step's change by the median leaf, whose sound runs read
within three times of the control's.

Leaves whose reference gradient is nought to rounding are left out of the
updates by `traincheck.ROUNDING`."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .traincheck import ROUNDING, _leaf_gaps, norms
from .traincheck import all_gaps as all_single


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The median leaf's gradient gap and change gap of one record (see
    `traincheck.gaps` for the records)."""
    inf = float("inf")
    gp, gr = norms(prog["grads"]), norms(ref["grads"])
    if set(gp) != set(gr) or not gr:
        return {"grad_gap.median_leaf": inf, "update_gap": inf}
    names = sorted(gr)
    med = float(torch.tensor([gr[n] for n in names]).median())
    moving = [n for n in names if gr[n] >= ROUNDING * med]
    dp = norms({n: prog["end"][n] - prog["start"][n] for n in moving})
    dr = norms({n: ref["end"][n] - ref["start"][n] for n in moving})
    return {"grad_gap.median_leaf": float(_leaf_gaps(gp, gr, names).median()),
            "update_gap": float(_leaf_gaps(dp, dr, moving).median()) if moving else inf}


def all_gaps(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the numbers compared, the numbers shown): the set-up steps' and the
    window step's ("window."); the window's are inf where the program ran
    no window step."""
    compared = gaps(prog, ref)
    window = (gaps(prog["window"], ref["window"]) if prog.get("window") is not None
              else {k: float("inf") for k in compared})
    compared["window.grad_gap.median_leaf"] = window["grad_gap.median_leaf"]
    shown = dict(all_single(prog, ref), **{"window.update_gap.median_leaf": window["update_gap"]})
    return compared, shown
