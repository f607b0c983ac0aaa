"""netCDF domain / phase-table files (copy of i3rc_tpu/io)."""
