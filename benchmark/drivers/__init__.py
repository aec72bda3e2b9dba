"""One module per traffic kind, found by the `driver` of a cell's file."""
