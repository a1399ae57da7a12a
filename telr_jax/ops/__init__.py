from telr_jax.ops.intervals import Intervals, merge_intervals, intersect_wao, closest
