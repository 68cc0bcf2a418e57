"""JAX's own spread in bfloat16: the jitted train step against the same
step under ``jax.disable_jit``, on ``tests/test_torch_bf16.py``'s train
step cases.  Prints, per case, the smallest per-leaf cosine of the two
steps' gradients over the leaves that carry at least 1e-3 of the global
norm, and the largest leaf difference over the global norm: the numbers
``LEAF_COSINE`` and ``LEAF_DIFF`` of that test are set at twice this
spread; and the smallest cosine over the encoder CBHG's front (its conv
bank, ``bank_bn`` and ``proj_1``), where ``FRONT_COSINE`` is set at twice
the spread.  The gradients are read through Adam's first moments, as the test
reads them.  Takes a few minutes on the CPU (the eager step runs op by
op):

    python tests/bf16_spread.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from test_torch_bf16 import FRONT, _leaf_stats, bf16_step_pair  # noqa: E402


def main() -> None:
    for guided in (False, True):
        _, jit_m, _, _, _ = bf16_step_pair(guided, jit=True)
        _, eager_m, _, _, _ = bf16_step_pair(guided, jit=False)
        cosines, diffs = _leaf_stats(eager_m, jit_m)
        worst = min(cosines, key=cosines.get)
        widest = max(diffs, key=diffs.get)
        front = {k: v for k, v in cosines.items() if k.startswith(FRONT)}
        low = min(front, key=front.get)
        print(f"guided={guided}: min cosine {cosines[worst]:.4f} ({worst}), "
              f"max leaf difference {diffs[widest]:.5f} of the norm "
              f"({widest}); encoder front min cosine {front[low]:.5f} "
              f"({low})", flush=True)


if __name__ == "__main__":
    main()
