"""Error policy and namelist reading (copies of i3rc_tpu/utils)."""
