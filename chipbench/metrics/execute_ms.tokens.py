"""Mean of the program's ``execute`` span (``InferenceEngine.execute``
through ``serving.graphs`` to the kernels, each dispatch synchronised
while traced) over the window's ticks, on the host clock."""
UNIT, LAYER, MOVES = "ms", "serving.engine", "tokens_per_s"


def read(run):
    spans = run.spans.get("execute")
    return 1e3 * sum(spans) / len(spans) if spans else None
