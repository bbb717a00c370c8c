"""Port-side copies of the repo's tools/ harnesses, run as
`python -m recsys_examples_torch.tools.<name>` (`--device` defaults to cuda)."""
