"""`python -m videotuna_tpu_torch <command>` → the port's command registry."""

from videotuna_tpu_torch.cli.commands import main

if __name__ == "__main__":
    raise SystemExit(main())
