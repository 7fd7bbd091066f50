"""``python -m parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch``."""

import sys

from .cli import main

sys.exit(main())
