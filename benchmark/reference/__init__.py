"""The plain reference: exact PPR by power iteration and the numbers that
``correct`` compares. Imports nothing of the port."""
