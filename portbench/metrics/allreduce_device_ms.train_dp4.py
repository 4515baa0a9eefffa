"""Device ms a step of the collectives' kernels (NCCL's, named ``nccl...``
in the trace: the Sync-BN statistics, their gradients, the gradient
all-reduce and the loss's), summed over the ranks' traces of the window,
over the ranks and the window's steps. None where the trace holds none."""


def read(data: dict):
    s = sum(v for k, v in data["device_ops"].items() if k.lower().startswith("nccl"))
    if s <= 0 or not data["steps"]:
        return None
    return 1e3 * s / data["ranks"] / data["steps"]
