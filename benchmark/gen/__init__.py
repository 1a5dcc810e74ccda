"""Generators: the genome of a configuration and the read pool of a run."""
