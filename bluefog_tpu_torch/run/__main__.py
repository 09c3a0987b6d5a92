from bluefog_tpu_torch.run.run import main

raise SystemExit(main())
