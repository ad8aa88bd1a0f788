import sys

from .astlint import main

sys.exit(main())
