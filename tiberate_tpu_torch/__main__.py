from tiberate_tpu_torch._cli import main

raise SystemExit(main())
