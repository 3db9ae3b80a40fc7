"""homolog_recall_pct: share of the planted homolog queries of the
window whose records name a subject of their source family."""


def read(run):
    j = run.judged
    if not j or not j["planted"]:
        return None
    return 100.0 * j["found"] / j["planted"]
