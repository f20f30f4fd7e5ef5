"""Device ms a train step on paths through ``gwen.graphcast.grid2mesh`` or
``gwen.graphcast.mesh2grid`` (GraphCast's grid blocks with their edge
embeddings; their backward too where they are recomputed), over the
``gwen.train_step`` spans begun in the window."""

from portbench import tap

tap.install()
SPANS = ("gwen.graphcast.grid2mesh", "gwen.graphcast.mesh2grid")


def read(run):
    sp = tap.span_trace(run)
    steps = sp.opened.get("gwen.train_step") if sp is not None else None
    if not steps or not any(sp.opened.get(s) for s in SPANS):
        return None
    return 1e3 * sp.under(SPANS) / steps
