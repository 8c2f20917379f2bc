"""AdamW and int8 gradient compression with error feedback."""
