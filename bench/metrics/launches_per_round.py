"""Device operations (kernels, copies, sets) of the traced call, a round."""


def read(ctx):
    view = ctx["view"]
    return len(view.device) / view.rounds if view.device else None
