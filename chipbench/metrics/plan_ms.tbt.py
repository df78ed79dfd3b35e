"""Mean of the program's ``plan`` span (``StepPlanner.build`` under
``TickServer``) over the window's ticks, on the host clock."""
UNIT, LAYER, MOVES = "ms", "serving.plan", "tbt_p95_ms"


def read(run):
    spans = run.spans.get("plan")
    return 1e3 * sum(spans) / len(spans) if spans else None
