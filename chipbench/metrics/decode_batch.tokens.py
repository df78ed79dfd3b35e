"""Mean number of slots decoded per tick over the window's ticks, from
the tick plans."""
UNIT, LAYER, MOVES = "slots", "serving.engine", "tokens_per_s"


def read(run):
    if not run.ticks:
        return None
    return sum(len(t.decode_ctx) for t in run.ticks) / len(run.ticks)
