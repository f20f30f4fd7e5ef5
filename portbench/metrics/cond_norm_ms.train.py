"""Device ms a train step on paths through ``gwen.op.cond_norm`` or
``gwen.op.cond_norm.bwd`` (GenCast's conditional LayerNorms, forward and
backward), over the ``gwen.train_step`` spans begun in the window."""

from portbench import tap

tap.install()
SPANS = ("gwen.op.cond_norm", "gwen.op.cond_norm.bwd")


def read(run):
    sp = tap.span_trace(run)
    steps = sp.opened.get("gwen.train_step") if sp is not None else None
    if not steps or not any(sp.opened.get(s) for s in SPANS):
        return None
    return 1e3 * sp.under(SPANS) / steps
