"""segment_sums' share of its roofline over the window, in %: the least
time of each launch's jobs (harness/roofline.segment_sum_work, from the
spy's shapes and each plan's kept rows) over the kernel's device time."""
from harness import roofline

KERNEL = "segment_sums_kernel"


def read(record):
    seconds = sum(s for name, (_, s) in record.get("kernels", {}).items()
                  if name == KERNEL or name.endswith("::" + KERNEL))
    return roofline.share_pct(record.get("calls", {}).get("segment_sums"), seconds)
