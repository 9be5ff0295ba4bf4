from .main import main_entry

main_entry()
