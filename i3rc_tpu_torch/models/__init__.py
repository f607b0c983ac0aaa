"""I3RC phase-1 scenes: the step cloud, the Landsat cloud and the radar cloud,
and the planeParallel slab (copies of i3rc_tpu/models; the scene data are
read from i3rc_tpu/models/data/)."""
