from .app.cli import main

raise SystemExit(main())
