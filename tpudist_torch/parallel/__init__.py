"""Multi-process training: process groups, rank topology, barriers."""
