"""The depthwise convolutions' share of the traced epoch's device busy
time: the device seconds of the kernel group "depthwise convolution"
(kernels named so, ``port_bench.trace.kernel_group``) over the busy
seconds."""

from port_bench.depthwise import GROUP


def read(run):
    t = run.traced
    if t is None or t.busy_s <= 0 or not t.groups.get(GROUP):
        return None
    return 100.0 * t.groups[GROUP] / t.busy_s
