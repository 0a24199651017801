"""Command lines of the port (counterparts of the JAX package's
``scripts/*.py`` that import ``distegnn_tpu``), each run as
``python -m distegnn_tpu_torch.scripts.<name>``, flag for flag as the JAX
script, plus ``--device`` where the script touches a device (``cuda`` by
default; without a card only ``--device cpu`` runs):

  serve_bench                    open-loop load through the serve stack
  traffic_gen                    mixed-traffic replay against a gateway
  check_no_print                 lint: no bare ``print(`` in the port
  check_route_spans              lint: every HTTP handler inside a span
  check_config_keys              lint: config defaults and validators agree
  measure_remat_memory           autograd's saved bytes with remat on / off
  partition_quality              edge cut and balance of the partitioners
  evaluate_rollout               multi-step rollout MSE per horizon
  evaluate_protein_equivariance  protein test MSE under rotation / shift

A script's stdout is its interface (one BENCH / JSON line where the JAX
script prints one), so the print lint allows this subpackage.
"""
