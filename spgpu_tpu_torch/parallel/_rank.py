"""The rank entry of :func:`spgpu_tpu_torch.parallel.group.run_ranks`:
``python -m spgpu_tpu_torch.parallel._rank DIR RANK SIZE DEVICE`` joins
the group and runs the job that the launcher wrote into ``DIR``."""

import sys

from spgpu_tpu_torch.parallel.group import rank_main

if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
