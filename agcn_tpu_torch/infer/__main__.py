"""`python -m agcn_tpu_torch.infer`: the port's streaming inference CLI."""

from agcn_tpu_torch.infer.cli import main

if __name__ == "__main__":
    main()
