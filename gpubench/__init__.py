"""
The benchmark of ``torchdrivesim_tpu_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json``::

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, cell, driver or per-layer
metric is a file of its own, found by name:

* ``configs/<config>.json``: the deployment's sizes, its source, what is
  assumed and what is changed from the source;
* ``workloads/<cell>.json``: the configuration, the driver, the traffic's
  parameters, the chips and why the cell exists;
* ``drivers/<driver>.py``: builds the cell on the device, runs its window,
  its traced segment and its correctness check (see :mod:`gpubench.harness`);
* ``metrics/<metric>.py``: reads one per-layer metric from a traced run.

The yardstick lives here too: the input generator (:mod:`gpubench.world`),
the bound arithmetic and the card's peaks (:mod:`gpubench.bounds`), the
trace reduction (:mod:`gpubench.trace`) and the plain reference that decides
``correct`` (:mod:`gpubench.reference`), which imports nothing of the
program.
"""
