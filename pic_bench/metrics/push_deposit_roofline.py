"""``push_deposit_roofline``: the fused gather, push and deposit kernel
(``csrc/fused_push_deposit.cu``, B1 and B2) against its bound, in %:
100 x the sum over its launches of each launch's least time over the
sum of their device times.

A launch's least time is the larger of its bytes over the HBM rate and
its f32 operations over the f32 peak (``push_deposit_forms.json``, a
frozen copy of ``chip_smoke.py``'s ``bound``): each particle column read
once and each output written once over the state's rows, the window
bases both ways, the field table read and the deposit slab written,
against the operations of the live rows.  The form of a launch comes
from the template arguments in its mangled name; the rows, live rows,
table rows and whether the work column is read come from the deck's
module (``trace.context["push_deposit"]``, keyed by form).  Without a
launch of a form it names, it reads nothing."""

import json
import re
from pathlib import Path

FORMS = json.loads((Path(__file__).with_name("push_deposit_forms.json"))
                   .read_text())
#: kBoris, kWork, kFull, kDeposit, kPacked of one instantiation, in a
#: mangled name (the compiler's report) or a demangled one (the trace's)
_BITS = (re.compile(r"fused_push_deposit_kernelILb([01])ELb([01])ELb([01])"
                    r"ELb([01])ELb([01])E"),
         re.compile(r"fused_push_deposit_kernel<" + ", ".join(
             [r"(true|false|1|0)"] * 5) + ">"))


def form_of(name: str):
    """The form a kernel name instantiates, as ``ops.fused.form_name``
    and ``packed_form_name`` name it, or None."""
    m = _BITS[0].search(name) or _BITS[1].search(name)
    if m is None:
        return None
    boris, _, full, deposit, packed = (b in ("1", "true") for b in m.groups())
    form = ("boris" if boris else "vay") + (
        "_packed" if packed else "_full" if full else "")
    return form + ("" if deposit else "_dep_skip")


def bound_s(form: str, ctx: dict) -> float:
    """The least seconds of one launch of ``form`` on the state that
    ``ctx`` describes (rows, live, table_rows, block, work_in)."""
    f = FORMS["forms"][form]
    row_bytes = f["row_bytes"] + (FORMS["work_in_bytes"] if ctx["work_in"]
                                  else 0)
    nbytes = (row_bytes * ctx["rows"]
              + FORMS["anchor_bytes"] * (ctx["rows"] // ctx["block"])
              + f["table_row_bytes"] * ctx["table_rows"])
    ops = f["ops_per_row"] * ctx["live"]
    return max(nbytes / FORMS["hbm_bytes_per_s"], ops / FORMS["f32_ops_per_s"])


def read(trace):
    ctx = trace.context.get("push_deposit", {})
    bound = spent = 0.0
    for name, a, b in trace.device:
        form = form_of(name)
        if form in ctx:
            bound += bound_s(form, ctx[form])
            spent += (b - a) * 1e-6
    if spent <= 0:
        return None
    return 100.0 * bound / spent
