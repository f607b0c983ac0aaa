"""Host-side tools (copies of the JAX package's ``tools/``): the Mie tables
(``python -m i3rc_tpu_torch.tools.mie``), the physical- and optical-
properties to domain converters (``tools.physical_to_domain``,
``tools.optical_to_domain``) and the refractive index of water and ice."""
