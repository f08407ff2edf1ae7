import sys

from tpudist_torch.serve.cli import main

sys.exit(main())
