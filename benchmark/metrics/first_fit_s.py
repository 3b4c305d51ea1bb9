"""first_fit_s: seconds of set-up's throwaway call, host clock closed by
``torch.cuda.synchronize()``: the first call on the graph, which pays the
route's plan and build."""


def read(run):
    return run.first_fit_s
