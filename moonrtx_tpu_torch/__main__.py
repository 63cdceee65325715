"""`python -m moonrtx_tpu_torch` runs the CLI (app.cli.main), as
`python -m moonrtx_tpu` does for the JAX package. The GUI launcher is
`python -m moonrtx_tpu_torch.app.launcher`."""

from moonrtx_tpu_torch.app.cli import main

if __name__ == "__main__":
    main()
