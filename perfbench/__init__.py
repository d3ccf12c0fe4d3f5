"""The benchmark of ``llmvox_tpu_torch``: one cell run once per call.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``README.md``).  Nothing here imports JAX or the JAX
package; the reference under ``reference/`` imports nothing of the port.
"""
