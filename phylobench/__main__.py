import sys

from phylobench.run import main

sys.exit(main())
