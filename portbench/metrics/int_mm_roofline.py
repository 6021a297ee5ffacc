"""int_mm_roofline (also int_mm_roofline.small, which moves request_p95_ms):
the sign-expansion matmul (`torch._int_mm` in ops/mxu.py) against its
roofline: the least time of each call, the larger of the operations its
real rows need (2 x Q x N x m x S) over the card's int8 peak and its bytes
(both operands and the int32 scores once) over HBM's, summed over the
window's calls, over their CUDA-event times."""

from portbench.readers import int_mm_roofline as read  # noqa: F401
