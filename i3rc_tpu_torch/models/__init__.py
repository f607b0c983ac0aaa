"""I3RC phase-1 scenes: the step cloud and the Landsat cloud (copies of
i3rc_tpu/models; the scene data are read from i3rc_tpu/models/data/)."""
