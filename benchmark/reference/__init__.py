"""The plain references the benchmark holds the program to. Nothing in this package imports the program."""
