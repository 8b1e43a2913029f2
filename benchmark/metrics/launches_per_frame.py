"""launches_per_frame: kernels run on the card in the traced window per
traced frame."""


def read(trace):
    return trace.kernel_launches() / trace.frames
