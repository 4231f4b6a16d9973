import sys

from kmertools_jax.cli import main

sys.exit(main())
