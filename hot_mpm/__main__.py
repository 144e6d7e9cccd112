from hot_mpm.cli import main

raise SystemExit(main())
