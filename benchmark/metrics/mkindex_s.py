"""mkindex_s: the harness's clock around the program's mkindexp call."""


def read(run):
    return run.mkindex_s
