"""index_load_s: the harness's clock around SearchContext(...), ended by
a synchronize: index read, prefix table, upload."""


def read(run):
    return run.index_load_s
