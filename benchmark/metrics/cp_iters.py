"""Outer loop: the mean number of cut-pursuit iterations
(``CPResult.it`` / ``CPOutput.it``) over the window's solves."""


def read(run):
    return sum(run.cp_iters) / len(run.cp_iters) if run.cp_iters else None
