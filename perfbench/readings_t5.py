"""``readings.py`` for every training cell with the faults of
``faults_t5.py`` (``faults.TRAIN`` and ``rmsnorm_bf16``), in one process
per cell:

    python3 perfbench/readings_t5.py --workload <cell> --seeds 6 \
        --seed0 <n> [--controls int8_full] \
        [--faults half_batch,rmsnorm_bf16] [--seconds 2]

It runs ``readings.main`` as it is, with that table for any driver (its
own picks ``faults.EMBED`` for a driver other than ``train_step``): one
JSON line per run with every compared number.
"""

import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import faults_t5, readings  # noqa: E402


def main(argv=None) -> int:
    readings.faults = types.SimpleNamespace(TRAIN=faults_t5.TRAIN,
                                            EMBED=faults_t5.TRAIN)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
