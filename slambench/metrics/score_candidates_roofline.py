"""score_candidates' share of its roofline over the window, in %: the least
time of each launch's work (harness/roofline.score_candidates_work, from the
spy's shapes) over the kernel's device time in the trace."""
from harness import roofline

KERNEL = "score_candidates_kernel"


def read(record):
    seconds = sum(s for name, (_, s) in record.get("kernels", {}).items()
                  if name == KERNEL or name.endswith("::" + KERNEL))
    return roofline.share_pct(record.get("calls", {}).get("score_candidates"), seconds)
