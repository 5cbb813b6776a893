"""repro_torch.launch - the launcher side of the port (twin of the JAX
package's ``repro.launch``): input specs on the ``meta`` device (``specs``),
the FLOP formulas each kernel op is charged (``flops``), the meshes and the
plan over them (``mesh``), the dry run on one card or the production meshes
(``dryrun``) with its H100 roofline (``roofline``) and tables (``report``),
and the training launcher (``train``: ``python -m repro_torch.launch.train``).

This package file imports nothing.  The layer points one way: ``launch``
imports ``kernels``, never the other way round.
"""
