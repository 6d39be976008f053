from .datagen import generate_test_rows, generate_sequence, rows_to_csv  # noqa: F401
