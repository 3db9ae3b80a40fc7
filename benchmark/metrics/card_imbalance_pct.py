"""card_imbalance_pct: how far the busiest of the mesh's four cards is
above an even share, over the untraced calls of a traced run: 100 x (4 x
the busiest card's device seconds (StatsHolder.dev_card_max_s, summed
over calls) / all four cards' (dev_card_sum_s) - 1).  0 where every card
works as long as the others, 300 where one card does all the work.
None where the program keeps no card clocks."""

from benchmark.harness.spans import recorded, untraced

# the cards of the cell this metric is listed for (blastp_shards4.proteome)
CARDS = 4


def read(run):
    keys = ("dev_card_sum_s", "dev_card_max_s")
    if not recorded(run, keys):
        return None
    calls = untraced(run)
    total = sum(c.stats["dev_card_sum_s"] for c in calls)
    if total <= 0:
        return None
    most = sum(c.stats["dev_card_max_s"] for c in calls)
    return 100.0 * (CARDS * most / total - 1.0)
