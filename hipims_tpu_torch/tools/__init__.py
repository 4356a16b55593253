"""Command-line tools of the port that are not part of a model run."""
