"""Plain NumPy reference: what the aligner has to answer, worked out anew
from the generated genome and reads. Imports nothing of the program."""
