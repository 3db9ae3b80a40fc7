"""card_overlap_x: how many of the mesh's cards work at once, over the
untraced calls of a traced run: the cards' own device seconds
(StatsHolder.dev_card_sum_s: CUDA events on each card around its seeding
passes and its pass-1 work) over the host seconds of seeding and pass 1
(time_seed + time_extend) of the same calls.  1 where the cards work one
after another, 4 where four work all at once.  None where the program
keeps no card clocks (no mesh, no card, or a program without them)."""

from benchmark.harness.spans import recorded, untraced


def read(run):
    keys = ("dev_card_sum_s", "time_seed", "time_extend")
    if not recorded(run, keys):
        return None
    calls = untraced(run)
    cards = sum(c.stats["dev_card_sum_s"] for c in calls)
    host = sum(c.stats["time_seed"] + c.stats["time_extend"] for c in calls)
    if cards <= 0 or host <= 0:
        return None
    return cards / host
